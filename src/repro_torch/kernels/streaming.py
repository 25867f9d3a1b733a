"""The bounded in-flight window of the stage-graph schedule (port of
``repro/kernels/streaming.py:87-123``).

Only :class:`InflightWindow` carries over.  The rest of the reference
module — ``VMEM_TABLE_BUDGET``, ``table_fits_vmem``, ``chunk_schedule``
and ``pad_rows`` — is the TPU kernels' VMEM streaming: which chunks of a
source table a row tile's DMA loop fetches into a core's 16 MB VMEM.  The
Pallas bodies use it inside themselves (``kernels/gat_na.py:233-306``);
a CUDA kernel reads its table through the 50 MB L2 and has no VMEM budget
to plan against, so none of those helpers has a counterpart here.

The window is the host-side analogue of that DMA double buffer: the
executor's ``forward_overlapped`` keeps up to ``depth`` stage results in
flight while the host goes on issuing dependents.  On the card a stage's
result is in flight until the event recorded on the stream that made it
has passed; admitting one more stage past the window synchronises the
oldest event.  ``depth <= 1`` synchronises every stage at once, which is
the serial baseline.  On the CPU every value is ready when it is
returned, so ``admit`` only counts; ``admitted`` and ``max_inflight``
are the reference's either way.
"""
from __future__ import annotations

from typing import Any, List, Optional

import torch
from torch.utils._pytree import tree_flatten


def _cuda_device(value) -> Optional[torch.device]:
    """The device of the first CUDA tensor in ``value``, else None."""
    for x in tree_flatten(value)[0]:
        if isinstance(x, torch.Tensor) and x.is_cuda:
            return x.device
    return None


class InflightWindow:
    """Bounded async-dispatch window for the stage-graph schedule: at most
    ``depth`` stage results in flight; admitting one more blocks on the
    oldest (``depth <= 1``: every admit blocks, the serial schedule)."""

    def __init__(self, depth: int):
        self.depth = max(int(depth), 1)
        self._live: List[Any] = []  # CUDA events (None: a CPU value)
        self.admitted: List[str] = []
        self.max_inflight = 0

    def admit(self, name: str, value):
        """Record ``value``, a stage's output made on the current stream,
        as in flight; block until the window has room for it."""
        self.admitted.append(name)
        dev = _cuda_device(value)
        event = None
        if dev is not None:
            event = torch.cuda.Event()
            event.record(torch.cuda.current_stream(dev))
        if self.depth <= 1:
            if event is not None:
                event.synchronize()
            self.max_inflight = max(self.max_inflight, 1)
            return value
        self._live.append(event)
        self.max_inflight = max(self.max_inflight, len(self._live))
        while len(self._live) > self.depth:
            self._wait(self._live.pop(0))
        return value

    @staticmethod
    def _wait(event) -> None:
        if event is not None:
            event.synchronize()

    def drain(self) -> None:
        """Block until every admitted stage has finished."""
        while self._live:
            self._wait(self._live.pop(0))
