"""Host-sharded synthetic token pipeline with background prefetch (port of
``repro/data/loader.py``; numpy only, byte-equal to the reference's).

Every batch is a pure function of (step, host shard): the elasticity
contract (``train/elastic.py``): any restarted host regenerates exactly the
slice it owes, with no central dispatcher.  The seed is the reference's
``hash((step, host_id)) % 2**31``; Python does not randomise the hash of a
tuple of ints, so it is the same in every process.
"""
from __future__ import annotations

import queue
import threading
from typing import Dict, Iterator

import numpy as np

from repro_torch.configs.base import ModelConfig, ShapeConfig


def synth_batch(cfg: ModelConfig, shape: ShapeConfig, step: int,
                host_id: int = 0, n_hosts: int = 1
                ) -> Dict[str, np.ndarray]:
    """Deterministic batch for (step, host)."""
    b = shape.global_batch // n_hosts
    rng = np.random.default_rng(hash((step, host_id)) % (2 ** 31))
    tokens = rng.integers(0, cfg.vocab, (b, shape.seq_len), dtype=np.int32)
    out = {"tokens": tokens, "labels": np.roll(tokens, -1, axis=1)}
    if cfg.family == "vlm":
        out["extra_embeds"] = rng.standard_normal(
            (b, cfg.n_frontend_embeds, cfg.d_model)).astype(np.float32) * 0.1
    if cfg.family == "encdec":
        out["frames"] = rng.standard_normal(
            (b, shape.seq_len, cfg.d_model)).astype(np.float32) * 0.1
    return out


class PrefetchLoader:
    """Background-thread prefetch of synth batches (depth-2 pipeline)."""

    def __init__(self, cfg: ModelConfig, shape: ShapeConfig,
                 start_step: int = 0, host_id: int = 0, n_hosts: int = 1,
                 depth: int = 2):
        self.cfg, self.shape = cfg, shape
        self.host_id, self.n_hosts = host_id, n_hosts
        self._q: "queue.Queue" = queue.Queue(maxsize=depth)
        self._step = start_step
        self._stop = threading.Event()
        self._t = threading.Thread(target=self._run, daemon=True)
        self._t.start()

    def _run(self):
        step = self._step
        while not self._stop.is_set():
            batch = synth_batch(self.cfg, self.shape, step, self.host_id,
                                self.n_hosts)
            while not self._stop.is_set():
                try:
                    self._q.put(batch, timeout=0.1)
                    break
                except queue.Full:
                    continue
            step += 1

    def __next__(self) -> Dict[str, np.ndarray]:
        return self._q.get()

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        return self

    def close(self):
        self._stop.set()
        try:
            while True:
                self._q.get_nowait()
        except queue.Empty:
            pass
        self._t.join(timeout=2.0)
