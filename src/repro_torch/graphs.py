"""Captured steps: the port's counterpart of the reference's ``jax.jit``
(port-only, beside ``interop.py`` and ``tree.py``).

The reference compiles its serving steps with ``jax.jit``: the
``HGNNInferEngine`` forward (``repro/serve/engine.py:48``), the
``HGNNServeEngine`` forward (``:205``, whose ``compiles_after_warmup``
diffs the jit cache, ``:516``), the LM decode step (``:588``) and the
forward that ``build_hgnn_infer`` returns (``repro/launch/serve.py:119,
129``).  :func:`compiled` stands at those sites here.  On the card it runs
a step once eagerly for each new signature, captures it into a
``torch.cuda.CUDAGraph`` and replays the graph on every later call with
that signature, as a jitted function traces once and then runs its
executable.

* **Dispatch by device.**  With no CUDA tensor among the arguments ``fn``
  is called as it is: the CPU tests and ``--device cpu``.  A DTensor
  raises: the mesh path runs eagerly.
* **One graph per signature.**  A signature is every array leaf's place,
  shape and dtype and the value of every other leaf.  A new one is run
  once on the device's capture stream (the warm-up: the kernels are built
  and ``kernels/build.scratch`` sizes its buffers for that stream, which
  every wrapper on the device shares), then captured there.  The
  wrapper's graphs share one memory pool, and each graph keeps the scratch
  buffers that its kernels read.  The first call of a signature returns
  the warm-up's result and later ones replay, so a step that writes a held
  input in place (the decode's caches) runs exactly once a call.  Off the
  card the signatures are counted too (``signatures``), so a caller learns
  what a capture would have been made for whether or not a card is there.
* **Two kinds of input.**  A CUDA tensor is *held*: the graph reads it
  where it lies.  Its address and strides are recorded at capture and
  checked on every call; a mismatch raises, and nothing is replayed onto a
  stale address.  A host array (numpy or a CPU tensor) is *uploaded* into
  the signature's own device buffer, which the graph reads: copied there
  ``non_blocking`` straight from the array when it lies in pinned memory
  (the served step's sampled feature tables do), else through the
  signature's pinned staging.  Either way the caller's array is free
  again when the call returns.
* **Outputs are the caller's.**  An output leaf that is a held input comes
  back as that input; every other tensor is a copy, so a later replay
  never changes a result already returned.
* **Launch counts.**  A replay runs no wrapper, so a graph's launches
  (``kernels/ops.launch_counts``) are the wrapper ticks of its capture,
  where each wrapper recorded its kernel into the graph; they must equal
  the warm-up's, or the capture raises.  The capture's ticks are taken
  back out (it launched nothing) and the graph's launches are added on
  every replay.  ``captures`` and ``replays`` count the wrapper's graphs
  and replays.
* **No fallback.**  A failed capture raises; nothing is retried eagerly.

The CUDA calls sit in :class:`_Card`, one object (``_card``) that a test
can stand in for.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch

from repro_torch import tree
from repro_torch.kernels import build, ops

HELD, HOST, STATIC = "held", "host", "static"


class _Card:
    """What a capture and a replay ask of the card."""

    def __init__(self):
        self._streams: Dict[torch.device, Any] = {}

    @staticmethod
    def resident(x: torch.Tensor) -> bool:
        return x.is_cuda

    def stream(self, device):
        """The device's capture stream, one for every wrapper, so that the
        graphs of all engines share ``build.scratch``'s buffers."""
        s = self._streams.get(device)
        if s is None:
            s = self._streams[device] = torch.cuda.Stream(device)
        return s

    @staticmethod
    def current(device):
        return torch.cuda.current_stream(device)

    @staticmethod
    def use(stream):
        return torch.cuda.stream(stream)

    @staticmethod
    def pool():
        return torch.cuda.graph_pool_handle()

    @staticmethod
    def capture(fn: Callable[[], Any], pool, stream):
        """``(graph, fn's output)`` with ``fn``'s kernels captured on
        ``stream`` into ``graph``, which allocates from ``pool``."""
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, pool=pool, stream=stream):
            out = fn()
        return graph, out

    @staticmethod
    def staging(shape, dtype) -> torch.Tensor:
        return torch.empty(shape, dtype=dtype, pin_memory=True)

    @staticmethod
    def pinned(x: torch.Tensor) -> bool:
        return x.is_pinned()

    @staticmethod
    def buffer(shape, dtype, device) -> torch.Tensor:
        return torch.empty(shape, dtype=dtype, device=device)

    @staticmethod
    def event():
        return torch.cuda.Event()

    @staticmethod
    def keep(x: torch.Tensor, stream) -> None:
        """``x``, made on another stream, is used on ``stream`` too."""
        x.record_stream(stream)

    @staticmethod
    def replay(g: "_Graph") -> None:
        g.graph.replay()


_card = _Card()


def _kind(x) -> str:
    if isinstance(x, torch.Tensor):
        if type(x).__name__ == "DTensor":
            raise TypeError(
                "compiled: a DTensor argument; a step on a device mesh runs "
                "eagerly (call the function itself)")
        return HELD if _card.resident(x) else HOST
    return HOST if isinstance(x, np.ndarray) else STATIC


def _dtype(x) -> torch.dtype:
    if isinstance(x, torch.Tensor):
        return x.dtype
    return torch.from_numpy(np.empty(0, x.dtype)).dtype


def _describe(x, kind: str) -> tuple:
    if kind == HELD:
        return (kind, str(x.device), tuple(x.shape), x.dtype)
    if kind == HOST:
        return (kind, tuple(x.shape), _dtype(x))
    try:
        hash(x)
    except TypeError:
        raise TypeError(f"compiled: an argument leaf of type "
                        f"{type(x).__name__} is neither an array nor "
                        "hashable") from None
    return (kind, type(x), x)


def _structure(t) -> Any:
    """The containers of a tree, in :func:`tree.leaves` order."""
    if isinstance(t, dict):
        return ("dict",) + tuple((k, _structure(t[k])) for k in sorted(t))
    if isinstance(t, (list, tuple)):
        return (type(t),) + tuple(_structure(v) for v in t)
    return None if t is None else "."


def _signature(args, flat: List, kinds: List[str]) -> tuple:
    return (_structure(args),
            tuple(_describe(x, k) for x, k in zip(flat, kinds)))


def on_card(args) -> bool:
    """Whether a call with ``args`` would run a captured graph: some leaf
    is a tensor on the card."""
    return any(isinstance(x, torch.Tensor) and _kind(x) == HELD
               for x in tree.leaves(args))


class _Graph:
    """One signature's graph: its held inputs' addresses, its upload
    buffers, its static output and the launches of one call."""

    def __init__(self, device, flat: List, kinds: List[str]):
        self.held = [(i, x.data_ptr(), x.stride())
                     for i, (x, k) in enumerate(zip(flat, kinds))
                     if k == HELD]
        # [leaf index, pinned staging (made when first needed), device
        # buffer]
        self.uploads: List[list] = []
        self.inputs = list(flat)
        # plain tensors even under inference_mode: a later call outside it
        # still writes them
        with torch.inference_mode(False):
            for i, (x, k) in enumerate(zip(flat, kinds)):
                if k == HOST:
                    buf = _card.buffer(tuple(x.shape), _dtype(x), device)
                    self.uploads.append([i, None, buf])
                    self.inputs[i] = buf
        self.upload_bytes = sum(b.numel() * b.element_size()
                                for _, _, b in self.uploads)
        self._done = _card.event() if self.uploads else None
        self.graph = None
        self.out = None
        self.alias: List[Optional[int]] = []
        self.launches: Dict[str, int] = {}
        self.scratch: List[torch.Tensor] = []  # kernel scratch it reads

    def check(self, flat: List) -> None:
        for i, ptr, stride in self.held:
            x = flat[i]
            if x.data_ptr() != ptr or x.stride() != stride:
                raise RuntimeError(
                    f"compiled: held argument {i} {tuple(x.shape)} "
                    f"{x.dtype} moved since its graph was captured (address "
                    f"{x.data_ptr():#x} stride {x.stride()}, captured at "
                    f"{ptr:#x} stride {stride}); a held tensor must stay "
                    "where it lies")

    def upload(self, flat: List) -> None:
        """The host leaves into the device buffers on the current stream:
        a leaf in pinned memory straight from there, any other through the
        staging, which is rewritten only after the last upload out of it
        has finished.  A copy straight from the caller's memory is waited
        for before this returns, so the caller may write it again."""
        if not self.uploads:
            return
        self._done.synchronize()
        direct = False
        with torch.inference_mode(False):
            for up in self.uploads:
                i, pin, buf = up
                x = flat[i]
                src = torch.from_numpy(x) if isinstance(x, np.ndarray) else x
                if _card.pinned(src):
                    buf.copy_(src, non_blocking=True)
                    direct = True
                    continue
                if pin is None:
                    pin = up[1] = _card.staging(tuple(buf.shape), buf.dtype)
                pin.copy_(src)
                buf.copy_(pin, non_blocking=True)
        self._done.record()
        if direct:
            self._done.synchronize()

    def result(self, out, flat: List):
        """``out`` (the graph's, or the warm-up's) as the caller's own: a
        held input comes back as itself, every other tensor as a copy."""
        leaves = tree.leaves(out)
        own = [flat[j] if j is not None else
               x.clone() if isinstance(x, torch.Tensor) else x
               for x, j in zip(leaves, self.alias)]
        return tree.unflatten(out, own)


class Compiled:
    """``fn`` compiled by :func:`compiled`; ``fn`` is the eager step."""

    def __init__(self, fn: Callable):
        self.fn = fn
        self.graphs: Dict[tuple, _Graph] = {}
        self.captures = 0
        self.replays = 0
        self._seen: set = set()  # the signatures of calls off the card
        self._pool = None

    @property
    def signatures(self) -> int:
        """The distinct signatures called so far: on the card one graph
        each, off it what a capture would have been made for."""
        return len(self.graphs) + len(self._seen)

    def __call__(self, *args):
        flat = tree.leaves(args)
        kinds = [_kind(x) for x in flat]
        sig = _signature(args, flat, kinds)
        held = {flat[i].device for i, k in enumerate(kinds) if k == HELD}
        if not held:
            self._seen.add(sig)
            return self.fn(*args)
        if len(held) > 1:
            raise ValueError(f"compiled: tensors on several devices "
                             f"{sorted(map(str, held))}")
        g = self.graphs.get(sig)
        if g is None:
            g, out = self._capture(args, flat, kinds, held.pop())
            self.graphs[sig] = g
            return g.result(out, flat)
        g.check(flat)
        g.upload(flat)
        _card.replay(g)
        ops.add_launch_counts(g.launches)
        self.replays += 1
        return g.result(g.out, flat)

    def graph_of(self, *args) -> Optional[_Graph]:
        """The graph that a call with ``args`` replays, once captured."""
        flat = tree.leaves(args)
        return self.graphs.get(_signature(args, flat,
                                          [_kind(x) for x in flat]))

    def _capture(self, args, flat, kinds, device):
        """Warm a new signature up on the capture stream, capture it, and
        return the graph and the warm-up's output."""
        if self._pool is None:
            self._pool = _card.pool()
        stream, cur = _card.stream(device), _card.current(device)
        g = _Graph(device, flat, kinds)
        inputs = tree.unflatten(args, g.inputs)
        before = ops.launch_counts()
        stream.wait_stream(cur)
        with _card.use(stream):
            g.upload(flat)
            out = self.fn(*inputs)
        warm = ops.launch_counts()
        with build.keeping(g.scratch):
            g.graph, g.out = _card.capture(lambda: self.fn(*inputs),
                                           self._pool, stream)
        ticks = ops.launch_counts()
        # what each wrapper recorded into the graph; the capture launched
        # nothing, so its ticks are taken back out
        g.launches = {k: n - warm[k] for k, n in ticks.items()}
        ops.add_launch_counts({k: -n for k, n in g.launches.items()})
        ran = {k: n - before[k] for k, n in warm.items()}
        if g.launches != ran:
            raise RuntimeError(
                f"compiled: the capture recorded the launches "
                f"{ {k: n for k, n in g.launches.items() if n} } but the "
                f"warm-up ran { {k: n for k, n in ran.items() if n} }: the "
                "step does not launch the same kernels on every call")
        ids = {id(x): i for i, (x, k) in enumerate(zip(flat, kinds))
               if k == HELD}
        g.alias = [ids.get(id(x)) for x in tree.leaves(g.out)]
        cur.wait_stream(stream)
        for x in tree.leaves(out):
            if isinstance(x, torch.Tensor) and id(x) not in ids:
                _card.keep(x, cur)
        self.captures += 1
        return g, out


def compiled(fn: Callable) -> Compiled:
    """``fn`` captured once a signature on the card and replayed, or called
    as it is off the card (the module docstring)."""
    return Compiled(fn)
