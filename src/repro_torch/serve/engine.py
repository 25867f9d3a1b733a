"""Serving engines (port of ``repro/serve/engine.py:32-59``).

``HGNNInferEngine`` — HGNN inference driven by a :class:`StagePlan`: the
engine holds the stage-graph executor (not a model class) and serves the
forward over the prepared batch.  The reference jits the forward; PyTorch
runs eagerly, so the engine calls it under ``torch.inference_mode``.  The
per-stage characterization hook (``characterize``) and the sampled-serving
``HGNNServeEngine`` are later items of the port (ROADMAP Queue 1 items 13
and 15); the LM ``ServeEngine`` is item 17.
"""
from __future__ import annotations

import torch


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
