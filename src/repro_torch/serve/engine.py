"""Serving engines (port of ``repro/serve/engine.py:32-59, 572-646``).

``HGNNInferEngine`` — HGNN inference driven by a :class:`StagePlan`: the
engine holds the stage-graph executor (not a model class) and serves the
forward over the prepared batch, and ``characterize`` gives the per-stage
records of ``core/characterize.py`` from the same plan.  The
sampled-serving ``HGNNServeEngine`` is a later item of the port (ROADMAP
Queue 1 item 13).

``ServeEngine`` — LM serving over the prefill / decode step functions of
``nn/transformer.py``: each wave of up to ``batch_slots`` requests is
left-padded to one length (with token 0, attended, as the reference does),
prefilled once, grafted into the decode caches, and decoded in lock-step.
Sampling is greedy, or categorical at a per-slot temperature from the
engine's own seeded ``torch.Generator`` (``jax.random`` streams cannot be
reproduced).

The reference jits the forward and the decode step; PyTorch runs eagerly,
so both engines call them under ``torch.inference_mode``.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.nn import transformer as tf


class HGNNInferEngine:
    """Plan-driven HGNN serving over one prepared full-graph batch."""

    def __init__(self, executor, params, batch, fn=None):
        self.executor = executor
        self.plan = executor.plan
        self.params = params
        self.batch = batch
        self.fn = fn if fn is not None else executor.forward

    def infer(self) -> torch.Tensor:
        """One full forward over the prepared batch -> logits."""
        with torch.inference_mode():
            return self.fn(self.params, self.batch)

    def characterize(self, n_chips: int = 1, timed: bool = False
                     ) -> Dict[str, Dict]:
        """Per-stage (FP/NA/SA/head) FLOPs, HBM bytes and roofline records
        from the serving code path — the paper's Fig. 3 breakdown; with
        ``timed`` (on the card) the stage and device times and the device
        time by kernel class too (Fig. 2 and Fig. 3 measured)."""
        return self.executor.stage_records(self.params, self.batch,
                                           n_chips=n_chips,
                                           timed=timed)["stages"]


@dataclasses.dataclass
class Request:
    prompt: np.ndarray  # [T] int32
    max_tokens: int = 32
    temperature: float = 0.0
    out_tokens: Optional[List[int]] = None


class ServeEngine:
    """LM serving engine; runs on the device of ``params["embed"]``.

    ``timings`` holds, per wave, the host-clock seconds to the first token
    (prefill, graft and the first sample) and of the decode steps, and the
    number of decode steps; both spans end where the engine reads tokens
    back to the host, which waits for the device."""

    def __init__(self, cfg: ModelConfig, params, batch_slots: int = 8,
                 max_len: int = 512, rng_seed: int = 0, eos_id: int = -1):
        self.cfg = cfg
        self.params = params
        self.slots = batch_slots
        self.max_len = max_len
        self.eos_id = eos_id
        self.device = params["embed"].device
        self.gen = torch.Generator(device=self.device).manual_seed(rng_seed)
        self.timings: List[dict] = []

    def _sample(self, logits: torch.Tensor,
                temps: Optional[torch.Tensor]) -> torch.Tensor:
        """Per-slot sampling: greedy where the temperature is <= 0,
        categorical otherwise.  ``temps`` is built once per wave; None
        means an all-greedy wave."""
        greedy = torch.argmax(logits, dim=-1)
        if temps is None:
            return greedy
        probs = torch.softmax(
            logits.float() / torch.clamp(temps, min=1e-6)[:, None], dim=-1)
        sampled = torch.multinomial(probs, 1, generator=self.gen)[:, 0]
        return torch.where(temps > 0.0, sampled, greedy)

    def generate(self, requests: List[Request]) -> List[Request]:
        """Pad prompts to a common length per wave, prefill once, then
        decode lock-step."""
        out: List[Request] = []
        with torch.inference_mode():
            for wave_start in range(0, len(requests), self.slots):
                wave = requests[wave_start: wave_start + self.slots]
                out.extend(self._run_wave(wave))
        return out

    def _run_wave(self, wave: List[Request]) -> List[Request]:
        cfg, dev = self.cfg, self.device
        t_start = time.perf_counter()
        b = len(wave)
        t0 = max(len(r.prompt) for r in wave)
        toks = np.zeros((b, t0), np.int32)
        for i, r in enumerate(wave):
            toks[i, t0 - len(r.prompt):] = r.prompt  # left-pad
        logits, pf_caches = tf.lm_prefill(
            self.params, cfg, torch.from_numpy(toks).to(dev))
        caches = tf.graft_prefill_caches(
            cfg, tf.init_kv_caches(cfg, b, self.max_len, dev), pf_caches, t0)
        del pf_caches
        max_new = max(r.max_tokens for r in wave)
        temps_host = np.array([r.temperature for r in wave], np.float32)
        temps = (torch.from_numpy(temps_host).to(dev)
                 if (temps_host > 0).any() else None)
        cur = self._sample(logits[:, 0], temps)
        outs = [[t] for t in cur.tolist()]
        t_first = time.perf_counter()
        done = np.zeros(b, bool)
        pos = torch.tensor(t0, device=dev)  # advanced on the device
        steps = 0
        for step in range(1, max_new):
            logits, caches = tf.lm_decode_step(self.params, cfg, cur[:, None],
                                               caches, pos)
            pos = pos + 1
            steps += 1
            cur = self._sample(logits[:, 0], temps)
            cur_host = cur.tolist()
            for i in range(b):
                if done[i] or step >= wave[i].max_tokens:
                    done[i] = True
                    continue
                outs[i].append(cur_host[i])
                if cur_host[i] == self.eos_id:
                    done[i] = True
            if done.all():
                break
        self.timings.append({"prefill_s": t_first - t_start,
                             "decode_s": time.perf_counter() - t_first,
                             "decode_steps": steps})
        for r, o in zip(wave, outs):
            r.out_tokens = o[: r.max_tokens]
        return wave
