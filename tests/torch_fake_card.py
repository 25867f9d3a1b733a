"""A stand-in for ``repro_torch.graphs._Card`` on the CPU (a helper of the
``graphs.compiled`` tests; not a test module, and it imports no jax).

A tensor whose storage :func:`on_card` marked (or a view of it; for a
DTensor, its local tensor's) counts as one on the card, staging is
"pinned", and a "graph" is ``fn`` itself.  A capture runs ``fn`` to learn
its output and then puts every marked storage back as it was, since a
real capture runs nothing (a step that donates its state would otherwise
take two steps at its first call).  A replay runs ``fn`` again on the
graph's static buffers and copies the result into the captured output,
with the launch counters and any ``characterize.Recorder`` left as a real
replay leaves them (it dispatches no op).  Each capture stream is an
object of its own (``stream(device, i)``), kept on the graph.

  monkeypatch.setattr(graphs, "_card", FakeCard())
"""
from __future__ import annotations

import contextlib

import torch
from torch.utils._python_dispatch import _disable_current_modes

from repro_torch import tree
from repro_torch.core import characterize
from repro_torch.kernels import ops

# storage address -> a tensor on it (kept, so the address is not reused):
# the storages that the stand-in card treats as on the card, views too
ON_CARD = {}


def _local(x):
    return getattr(x, "_local_tensor", x)


def on_card(t):
    """Mark the storages of ``t``'s tensors (a DTensor's local one) as on
    the card; returns ``t``."""
    for x in tree.leaves(t):
        if isinstance(x, torch.Tensor):
            x = _local(x)
            ON_CARD[x.untyped_storage().data_ptr()] = x
    return t


class _Nothing:
    def wait_stream(self, other):
        pass

    def synchronize(self):
        pass

    def record(self, stream=None):
        pass


class _Stream(_Nothing):
    """A capture stream: ``i`` says which of the device's."""

    def __init__(self, i):
        self.i = i


class _FakeGraph:
    def __init__(self, fn, out):
        self.fn, self.out = fn, out

    def replay(self):
        """``fn`` again on the static buffers, its output copied into the
        captured one; the wrappers it runs are not counted, as a real
        replay runs none, and no dispatch mode or recorder sees its ops."""
        before = ops.launch_counts()
        recorders = characterize._recorders[:]
        characterize._recorders.clear()
        try:
            with _disable_current_modes():
                new = self.fn()
        finally:
            characterize._recorders[:] = recorders
        ops.add_launch_counts({k: before[k] - n
                               for k, n in ops.launch_counts().items()})
        for dst, src in zip(tree.leaves(self.out), tree.leaves(new)):
            if isinstance(dst, torch.Tensor) and dst is not src:
                _local(dst).copy_(_local(src))


class FakeCard:
    """``graphs._Card`` on the CPU: tensors on a storage :func:`on_card`
    marked are held, and staging counts as pinned."""

    def __init__(self):
        self.captured = 0
        self._pinned = {}  # storage address -> a "pinned" tensor on it
        self._streams = {}  # i -> capture stream i

    @staticmethod
    def resident(x):
        return x.untyped_storage().data_ptr() in ON_CARD

    def stream(self, device, i=0):
        return self._streams.setdefault(i, _Stream(i))

    def current(self, device):
        return _Nothing()

    def use(self, stream):
        return contextlib.nullcontext()

    def pool(self):
        return object()

    def capture(self, fn, pool, stream):
        self.captured += 1
        kept = [(x, x.untyped_storage().clone()) for x in ON_CARD.values()]
        out = fn()
        for x, saved in kept:
            x.untyped_storage().copy_(saved)
        return _FakeGraph(fn, out), out

    def staging(self, shape, dtype):
        x = torch.empty(shape, dtype=dtype)
        self._pinned[x.untyped_storage().data_ptr()] = x
        return x

    def pinned(self, x):
        return x.untyped_storage().data_ptr() in self._pinned

    @staticmethod
    def buffer(shape, dtype, device, stride=None):
        if stride is None:
            return torch.empty(shape, dtype=dtype)
        return torch.empty_strided(shape, stride, dtype=dtype)

    def event(self):
        return _Nothing()

    @staticmethod
    def keep(x, stream):
        pass

    @staticmethod
    def replay(g):
        g.graph.replay()
