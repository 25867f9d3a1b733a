"""Captured steps: the port's counterpart of the reference's ``jax.jit``
(port-only, beside ``interop.py`` and ``tree.py``).

The reference compiles its steps with ``jax.jit``: the ``HGNNInferEngine``
forward (``repro/serve/engine.py:48``), the ``HGNNServeEngine`` forward
(``:205``, whose ``compiles_after_warmup`` diffs the jit cache, ``:516``),
the LM decode step (``:588``), the forward that ``build_hgnn_infer``
returns, on one device and on a mesh (``repro/launch/serve.py:119,
129``), the mesh steps of ``jit_step`` with their shardings and donation
(``repro/launch/steps.py:150``), the training launcher's step
(``repro/launch/train.py:53``, ``donate_argnums=(0,)``) and the executor's
per-stage jits: ``forward_overlapped``'s, one a stage key cached on the
executor (``_ovjit``, ``repro/core/pipeline.py:924``), and those of
``stage_fns`` and ``overlap_stage_fns`` (``:1047-1090``).
:func:`compiled` stands at those sites here.  On the card it runs a step once eagerly for
each new signature, captures it into a ``torch.cuda.CUDAGraph`` and
replays the graph on every later call with that signature, as a jitted
function traces once and then runs its executable.

* **Dispatch by device.**  With no CUDA tensor among the arguments ``fn``
  is called as it is: the CPU tests, ``--device cpu`` and a gloo mesh.
* **One graph per signature.**  A signature is every array leaf's place,
  shape and dtype, a DTensor's mesh, placements, global shape and stride,
  and the value of every other leaf.  A new one is run once on the
  device's capture stream (the warm-up: the kernels are built,
  ``kernels/build.scratch`` sizes its buffers for that stream, an
  autograd backward starts its device thread and a collective its
  communicator), then captured there.  Every wrapper captures on the
  device's capture stream 0, so their graphs share the scratch of one
  stream, but a wrapper made with ``stream=i`` captures on the device's
  capture stream ``i``: a sibling branch of the async schedule, whose
  graph replays on a side stream while branch 0's replay on the caller's,
  so that the two never share a kernel's counters.
  The wrapper's graphs share one memory pool, and each graph keeps the
  scratch buffers that its kernels read.  The first call of a signature
  returns the warm-up's result and later ones replay, so a step that
  writes a held input in place (the decode's caches) or a donated one
  (a train step's state) runs exactly once a call.  One warm-up is
  enough for a backward: ``train_step`` takes its gradients with
  ``torch.autograd.grad`` into new tensors, so there is no ``.grad`` to
  accumulate into and no hook that a second step would set up.  Off the
  card the signatures are counted too (``signatures``), so a caller
  learns what a capture would have been made for whether or not a card
  is there.
* **Three kinds of input.**  A CUDA tensor is *held*: the graph reads it
  where it lies.  Its address and strides are recorded at capture and
  checked on every call; a mismatch raises, and nothing is replayed onto
  a stale address.  A host array (numpy or a CPU tensor) is *uploaded*
  into the signature's own device buffer, which the graph reads: copied
  there ``non_blocking`` straight from the array when it lies in pinned
  memory (the served step's sampled feature tables do), else through the
  signature's pinned staging.  Either way the caller's array is free
  again when the call returns.  A CUDA tensor at a position named by
  ``copied=`` (a token or a position that the caller makes anew each
  step, from an ``argmax`` say) is *copied* into the signature's own
  device buffer on the caller's stream before the replay, so it need not
  stay where it lies.
* **DTensors.**  A DTensor leaf is held, uploaded or copied through its
  local tensor; its mesh, placements, global shape and stride are static
  parts of the signature.  The graph sees a DTensor rebuilt once around
  the held local tensor, or around the signature's buffer
  (``DTensor.from_local(..., run_check=False, shape=, stride=)``: host
  work only, it launches nothing), so a replay pays no DTensor dispatch:
  that was paid once, at capture.  A DTensor output comes back as a copy
  of its local tensor with the same spec.
* **Donation** (``donate=``, the reference's ``donate_argnums``).  Each
  donated argument's counterpart in the output (the first element of the
  output tuple with that argument's tree structure, leaf shapes and
  dtypes, or the whole output if it is one) is copied into the
  argument's own tensors inside the captured region, and the call
  returns those tensors in its place.  A train loop so passes the same
  addresses on every call.  As under JAX's donation, the caller's old
  state is gone after the call: its tensors hold the new one.  Every
  leaf of a donated argument must be a tensor on the card.  Off the card
  nothing is donated: ``fn`` runs as it is.
* **Outputs are the caller's.**  An output leaf that is a held or donated
  input comes back as that input; every other tensor is a copy, so a
  later replay never changes a result already returned.
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

import functools
import gc
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch import tree
from repro_torch.dist.sharding import copy_into
from repro_torch.kernels import build, ops

HELD, HOST, COPIED, STATIC = "held", "host", "copied", "static"


class _Card:
    """What a capture and a replay ask of the card."""

    def __init__(self):
        self._streams: Dict[torch.device, Any] = {}

    @staticmethod
    def resident(x: torch.Tensor) -> bool:
        return x.is_cuda

    def stream(self, device, i: int = 0):
        """The device's capture stream ``i``: 0 for every wrapper but a
        sibling branch of the async schedule, so that the graphs of all
        engines share ``build.scratch``'s buffers of one stream."""
        s = self._streams.get((device, i))
        if s is None:
            s = self._streams[(device, i)] = torch.cuda.Stream(device)
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
        ``stream`` into ``graph``, which allocates from ``pool``.  Python's
        cyclic garbage collector is off meanwhile: a collection could
        destroy another graph (an executor and the compiled stages that
        close over it are a cycle), which the card does not permit while
        a stream captures."""
        graph = torch.cuda.CUDAGraph()
        collecting = gc.isenabled()
        gc.disable()
        try:
            with torch.cuda.graph(graph, pool=pool, stream=stream):
                out = fn()
        finally:
            if collecting:
                gc.enable()
        return graph, out

    @staticmethod
    def staging(shape, dtype) -> torch.Tensor:
        return torch.empty(shape, dtype=dtype, pin_memory=True)

    @staticmethod
    def pinned(x: torch.Tensor) -> bool:
        return x.is_pinned()

    @staticmethod
    def buffer(shape, dtype, device, stride=None) -> torch.Tensor:
        if stride is None:
            return torch.empty(shape, dtype=dtype, device=device)
        return torch.empty_strided(shape, stride, dtype=dtype, device=device)

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


@functools.cache
def _dtensor():
    from torch.distributed.tensor import DTensor

    return DTensor


def _dt(x) -> bool:
    """Whether ``x`` is a DTensor (a plain tensor answers at once)."""
    return (isinstance(x, torch.Tensor) and type(x) is not torch.Tensor
            and isinstance(x, _dtensor()))


def _local(x):
    """A DTensor's local tensor; any other leaf as it is."""
    return x._local_tensor if _dt(x) else x


def _spec(x):
    """A DTensor's static parts, its ``DTensorSpec``: mesh, placements,
    global shape, stride and dtype (None for any other leaf)."""
    return x._spec if _dt(x) else None


def _wrap(local: torch.Tensor, spec):
    """``local`` as the DTensor ``spec`` describes (as it is for None),
    rebuilt once a graph: host work only, nothing is launched."""
    if spec is None:
        return local
    meta = spec.tensor_meta
    return _dtensor().from_local(local, spec.mesh, spec.placements,
                                 run_check=False, shape=meta.shape,
                                 stride=meta.stride)


def _kind(x, copied: bool = False) -> str:
    if isinstance(x, torch.Tensor):
        if not _card.resident(_local(x)):
            return HOST
        return COPIED if copied else HELD
    return HOST if isinstance(x, np.ndarray) else STATIC


def _dtype(x) -> torch.dtype:
    if isinstance(x, torch.Tensor):
        return x.dtype
    return torch.from_numpy(np.empty(0, x.dtype)).dtype


def _describe(x, kind: str) -> tuple:
    if kind in (HELD, COPIED):
        loc = _local(x)
        stride = loc.stride() if kind == COPIED else None
        return (kind, str(loc.device), tuple(loc.shape), x.dtype, stride,
                _spec(x))
    if kind == HOST:
        return (kind, tuple(_local(x).shape), _dtype(x), _spec(x))
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


def _like(a, b) -> bool:
    """Whether ``a`` is a tree of ``b``'s structure with tensor leaves of
    ``b``'s shapes and dtypes (a donated argument's counterpart)."""
    if _structure(a) != _structure(b):
        return False
    la, lb = tree.leaves(a), tree.leaves(b)
    return all(isinstance(x, torch.Tensor) and isinstance(y, torch.Tensor)
               and x.shape == y.shape and x.dtype == y.dtype
               for x, y in zip(la, lb))


def on_card(args) -> bool:
    """Whether a call with ``args`` would run a captured graph: some leaf
    is a tensor (or a DTensor's local tensor) on the card."""
    return any(isinstance(x, torch.Tensor) and _kind(x) == HELD
               for x in tree.leaves(args))


class _Graph:
    """One signature's graph: its held inputs' addresses, its upload and
    copy buffers, the inputs the step sees, its static output and the
    launches of one call."""

    def __init__(self, device, flat: List, kinds: List[str]):
        self.held = [(i, _local(x).data_ptr(), _local(x).stride())
                     for i, (x, k) in enumerate(zip(flat, kinds))
                     if k == HELD]
        # [leaf index, pinned staging (made when first needed), device
        # buffer] of a host leaf; (leaf index, device buffer) of a copied
        self.uploads: List[list] = []
        self.copies: List[Tuple[int, torch.Tensor]] = []
        # plain tensors even under inference_mode: a later call outside it
        # still writes them
        with torch.inference_mode(False):
            for i, (x, k) in enumerate(zip(flat, kinds)):
                loc = _local(x)
                if k == HOST:
                    buf = _card.buffer(tuple(loc.shape), _dtype(x), device)
                    self.uploads.append([i, None, buf])
                elif k == COPIED:
                    buf = _card.buffer(tuple(loc.shape), loc.dtype, device,
                                       stride=loc.stride())
                    self.copies.append((i, buf))
        # what the step sees: a buffer in place of its leaf, a DTensor
        # rebuilt around its local tensor or buffer
        bufs = {i: b for i, _, b in self.uploads}
        bufs.update(self.copies)
        self.inputs = [_wrap(bufs.get(i, _local(x)), _spec(x))
                       if k != STATIC else x
                       for i, (x, k) in enumerate(zip(flat, kinds))]
        self.upload_bytes = sum(b.numel() * b.element_size()
                                for _, _, b in self.uploads)
        self._done = _card.event() if self.uploads else None
        self.graph = None
        self.out = None
        self.alias: List[Optional[int]] = []
        self.launches: Dict[str, int] = {}
        self.scratch: List[torch.Tensor] = []  # kernel scratch it reads
        self.stream = None  # the capture stream it was captured on

    def check(self, flat: List) -> None:
        for i, ptr, stride in self.held:
            x = _local(flat[i])
            if x.data_ptr() != ptr or x.stride() != stride:
                raise RuntimeError(
                    f"compiled: held argument {i} {tuple(x.shape)} "
                    f"{x.dtype} moved since its graph was captured (address "
                    f"{x.data_ptr():#x} stride {x.stride()}, captured at "
                    f"{ptr:#x} stride {stride}); a held tensor must stay "
                    "where it lies")

    def upload(self, flat: List) -> None:
        """The copied leaves, then the host leaves, into the device
        buffers on the current stream: a copied leaf device to device, a
        host leaf in pinned memory straight from there, any other through
        the staging, which is rewritten only after the last upload out of
        it has finished.  A copy straight from the caller's host memory is
        waited for before this returns, so the caller may write it again;
        a copied leaf may be written again at once, on its stream."""
        with torch.inference_mode(False):
            for i, buf in self.copies:
                buf.copy_(_local(flat[i]), non_blocking=True)
            if not self.uploads:
                return
            self._done.synchronize()
            direct = False
            for up in self.uploads:
                i, pin, buf = up
                x = _local(flat[i])
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
        held or donated input comes back as itself, every other tensor as
        a copy (a DTensor's local tensor copied, its spec kept)."""
        def own(x, j):
            if j is not None:
                return flat[j]
            if not _dt(x):
                return x.clone() if isinstance(x, torch.Tensor) else x
            # the graph's output spec around a copy of its local tensor
            return _dtensor()(x._local_tensor.clone(), x._spec,
                              requires_grad=x.requires_grad)

        return tree.unflatten(out, [own(x, j) for x, j in
                                    zip(tree.leaves(out), self.alias)])


class Compiled:
    """``fn`` compiled by :func:`compiled`; ``fn`` is the eager step."""

    def __init__(self, fn: Callable, donate: Sequence[int] = (),
                 copied: Sequence[int] = (), stream: int = 0):
        self.fn = fn
        self.donate = tuple(donate)
        self.copied = frozenset(copied)
        self.stream = stream
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

    def _leaves(self, args) -> Tuple[List, List[str], tuple]:
        """The leaves of ``args``, their kinds and the call's signature."""
        flat, kinds = [], []
        for pos, a in enumerate(args):
            leaves = tree.leaves(a)
            flat += leaves
            kinds += [_kind(x, pos in self.copied) for x in leaves]
        return flat, kinds, _signature(args, flat, kinds)

    def __call__(self, *args):
        flat, kinds, sig = self._leaves(args)
        held = {_local(flat[i]).device for i, k in enumerate(kinds)
                if k in (HELD, COPIED)}
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
        return self.graphs.get(self._leaves(args)[2])

    def _step(self, inputs: tuple):
        """``fn`` on the graph's inputs, with each donated argument's
        counterpart copied into that argument's tensors, which take its
        place in the output (module docstring)."""
        out = self.fn(*inputs)
        if not self.donate:
            return out
        whole = len(self.donate) == 1 and _like(out, inputs[self.donate[0]])
        parts = [out] if whole else tree._children(out) or []
        taken = set()
        for pos in self.donate:
            arg = inputs[pos]
            k = next((k for k, part in enumerate(parts)
                      if k not in taken and _like(part, arg)), None)
            if k is None:
                raise ValueError(
                    f"compiled: no element of the output has donated "
                    f"argument {pos}'s structure, shapes and dtypes")
            taken.add(k)
            for dst, src in zip(tree.leaves(arg), tree.leaves(parts[k])):
                if src is not dst:
                    copy_into(dst, src)
            parts[k] = arg
        return parts[0] if whole else tree._rebuild(out, parts)

    def _capture(self, args, flat, kinds, device):
        """Warm a new signature up on the capture stream, capture it, and
        return the graph and the warm-up's output."""
        if self.donate:
            first = 0
            for pos, a in enumerate(args):
                n = len(tree.leaves(a))
                if pos in self.donate and any(
                        k != HELD for k in kinds[first:first + n]):
                    raise ValueError(
                        f"compiled: donated argument {pos} holds a leaf "
                        "that is not a tensor on the card")
                first += n
        if self._pool is None:
            self._pool = _card.pool()
        stream = _card.stream(device, self.stream)
        cur = _card.current(device)
        g = _Graph(device, flat, kinds)
        g.stream = stream
        inputs = tree.unflatten(args, g.inputs)
        before = ops.launch_counts()
        stream.wait_stream(cur)
        with _card.use(stream):
            g.upload(flat)
            out = self._step(inputs)
        warm = ops.launch_counts()
        with build.keeping(g.scratch):
            g.graph, g.out = _card.capture(lambda: self._step(inputs),
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
        # the objects the step saw for the held inputs (a DTensor rebuilt)
        ids = {id(g.inputs[i]): i for i, k in enumerate(kinds) if k == HELD}
        g.alias = [ids.get(id(x)) for x in tree.leaves(g.out)]
        cur.wait_stream(stream)
        for x in tree.leaves(out):
            if isinstance(x, torch.Tensor) and id(x) not in ids:
                _card.keep(_local(x), cur)
        self.captures += 1
        return g, out


def compiled(fn: Callable, donate: Sequence[int] = (),
             copied: Sequence[int] = (), stream: int = 0) -> Compiled:
    """``fn`` captured once a signature on the card and replayed, or called
    as it is off the card (the module docstring).  ``donate``: the
    positions of arguments whose tensors the call overwrites with their
    counterparts in the output and returns (the reference's
    ``donate_argnums``; the caller's old values are gone).  ``copied``:
    the positions of arguments whose tensors on the card are copied into
    the signature's own buffers each call instead of held.  ``stream``:
    which of the device's capture streams the graphs are captured on (0,
    the one every other wrapper shares, but for a sibling branch of the
    async schedule)."""
    return Compiled(fn, donate, copied, stream)
