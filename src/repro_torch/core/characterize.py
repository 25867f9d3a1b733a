"""Workload characterization of the port (port of
``repro/core/characterize.py``): the paper's kernel classes, per-stage
FLOPs and HBM bytes, an H100 roofline, measured stage and device times.

The paper sorts CUDA kernels into four classes and attributes time, bytes
and arithmetic intensity to each (Fig. 3, Table 3).  The reference runs on
a TPU, which has no CUDA kernels, so it walks the compiled HLO and
predicts each class's time from a roofline.  Here each stage is counted
and profiled as it runs eagerly (a captured stage's replay dispatches no
op and launches its kernels with no aten op around them), so:

* **Records** (:class:`Recorder`): a ``TorchDispatchMode`` counts every
  aten op a stage runs by the reference's rule for an unfused op
  (``CostWalker.walk``): bytes are the tensor operands plus the result; a
  DM op (``mm``, ``addmm``, ``bmm``, ``baddbmm``, ``mv``, ``addmv``,
  ``dot``) has ``2·M·N·K`` FLOPs; an EW or TB op as many FLOPs as its
  result has elements; DR and OTHER ops have none.  The classes are the
  reference's: DM, TB (``index``, ``index_select``, ``gather``,
  ``scatter*``, ``index_add``, ``index_put``, ``index_copy``,
  ``embedding``, ``take``), EW (every other op that computes a tensor),
  DR (copies, ``cat``, ``stack``, ``pad``, ``clone``/``contiguous``, and
  the fill and factory ops below), COLL (collectives), OTHER (sort, random
  draws) and ZERO (views: free).  Rules for what an HLO walk never meets:

  - an op whose result aliases an input (its schema marks a view, or its
    result shares an input's storage, as ``_unsafe_view`` does) is ZERO;
  - ``empty`` and its kin allocate and are ZERO; ``zeros``, ``full``,
    ``fill_``, ``zero_`` and their kin write their result and read
    nothing: DR, the result's bytes;
  - an argument that an op writes in place counts once, as its result.

* **Declared work**: the hand-written kernels launch through ``ctypes``,
  so the dispatcher never sees them.  ``kernels/ops.py`` declares each
  kernel-arm call's class, FLOPs and bytes (the ``work`` helper beside the
  kernel's wrapper, counting gathers structurally: a row read an index
  slot, live or masked, as the HLO walker charges a gather) and pauses the
  recorder inside the call.  On the CPU the plain version runs in the
  kernel's place and counts as the kernel, so the CPU and the card give
  the same records.

* **Times** (:func:`stage_time_us`, :func:`device_times_us`, CUDA only):
  CUDA events around a stage callable (``stage_records`` times the
  stage's CUDA graph replayed, as the reference times its jitted stage),
  and the eager stage's device kernels from
  ``torch.profiler`` (a window a stage), each kernel classed by its symbol (the port's own,
  :data:`KERNEL_CLASS`), else by the aten op that launched it (the same
  table as the records), memset and memcpy as DR; anything left is OTHER
  and its name is kept.

:func:`roofline` takes the reference's keys with the H100's constants.

The LM records (the reference's ``:558-644``): :func:`analytic_param_counts`
from a meta-device init, :func:`model_flops`, and :func:`analyze_step`, the
counterpart of ``analyze_compiled`` / ``analyze_jitted``: a built step
(``launch/steps.py``) runs on meta DTensors under its mesh inside a
:class:`MeshRecorder`, which lets DTensor turn each op into its local op
and collectives and counts those, so every number is one rank's.
The pure-Python records (:func:`partition_traffic`,
:func:`sample_traffic`, :func:`residency_record`,
:func:`resilience_record`, :func:`overlap_accounting`) are the
reference's, for tensor inputs too.
"""
from __future__ import annotations

import contextlib
import re
from collections import defaultdict
from typing import Callable, Dict, List, Optional, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

# NVIDIA H100 SXM data sheet (dense, no sparsity), at its 700 W limit
HBM_BW = 3.35e12  # bytes/s
PEAK_FLOPS = {torch.float32: 67e12,  # fp32 outside the tensor cores
              torch.bfloat16: 989e12, torch.float16: 989e12}
LINK_BW = 900e9  # bytes/s, NVLink 4 (a GPU's total)

CLASSES = ("DM", "TB", "EW", "DR", "COLL", "OTHER")

DM_OPS = frozenset({"mm", "addmm", "bmm", "baddbmm", "mv", "addmv", "dot"})
TB_OPS = frozenset({
    "index", "index_select", "gather", "scatter", "scatter_add",
    "scatter_reduce", "index_add", "index_put", "_index_put_impl",
    "index_copy", "embedding", "take"})
DR_OPS = frozenset({
    "copy", "_to_copy", "_copy_from", "_copy_from_and_resize", "clone",
    "contiguous", "cat", "stack", "constant_pad_nd", "pad",
    "lift_fresh_copy", "_local_scalar_dense"})
FILL_OPS = frozenset({
    "fill", "zero", "zeros", "ones", "full", "zeros_like", "ones_like",
    "full_like", "new_zeros", "new_ones", "new_full", "scalar_tensor"})
FREE_OPS = frozenset({
    "empty", "empty_like", "empty_strided", "new_empty",
    "new_empty_strided", "resize", "set", "detach"})
OTHER_OPS = frozenset({
    "sort", "argsort", "topk", "_unique", "_unique2", "unique_dim",
    "unique_consecutive", "rand", "randn", "randint", "rand_like",
    "randn_like", "normal", "uniform", "bernoulli", "multinomial",
    "random", "exponential"})
COLL_NAMESPACES = ("c10d", "_c10d_functional", "c10d_functional")

# The port's CUDA kernels (``kernels/csrc/*.cu``) by symbol: gat_na in
# every form (its score sum too), segment_spmm, segment_sum and
# cached_gather are TB; fused_fp_na, semantic_scores and the two
# attention kernels DM; semantic_combine EW.
KERNEL_CLASS = {
    "gat_na_kernel": "TB", "sum_scores_kernel": "TB",
    "segment_spmm_kernel": "TB", "segment_sum_kernel": "TB",
    "segment_sum_long_kernel": "TB", "cached_gather_kernel": "TB",
    "fused_fp_na_kernel": "DM", "semantic_scores_kernel": "DM",
    "flash_attention_kernel": "DM", "flash_attention_tc_kernel": "DM",
    "decode_split_kernel": "DM", "decode_combine_kernel": "DM",
    "semantic_combine_kernel": "EW",
}
_KERNEL_RE = re.compile(r"\b(" + "|".join(KERNEL_CLASS) + r")\b")


def _base(name: str) -> str:
    """An op's name without namespace and without the trailing ``_`` of
    its in-place form (``"aten::index_add_"`` -> ``"index_add"``)."""
    base = name.rpartition("::")[2]
    return base[:-1] if base.endswith("_") and not base.endswith("__") \
        else base


def op_class(name: str) -> str:
    """Class of an aten op by name (``"aten::index_add_"``, ``"mm"``):
    the one table of the records and of the device times.  ZERO for the
    allocating ops; a view is told apart by its schema, not by name."""
    if name.rpartition("::")[0] in COLL_NAMESPACES:
        return "COLL"
    base = _base(name)
    if base in DM_OPS:
        return "DM"
    if base in TB_OPS:
        return "TB"
    if base in DR_OPS or base in FILL_OPS:
        return "DR"
    if base in FREE_OPS:
        return "ZERO"
    if base in OTHER_OPS:
        return "OTHER"
    return "EW"


def kernel_class(name: str) -> Optional[str]:
    """Class of a device kernel by its own name: the port's kernels by
    symbol, memset and memcpy as DR; None for the rest (classed by the
    aten op that launched them)."""
    m = _KERNEL_RE.search(name)
    if m:
        return KERNEL_CLASS[m.group(1)]
    if name.startswith(("Memcpy", "Memset")):
        return "DR"
    return None


# ---------------------------------------------------------------------------
# the recorder: FLOPs and HBM bytes by class
# ---------------------------------------------------------------------------

_recorders: List["Recorder"] = []  # in use, the innermost last


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _tensors(tree) -> List[torch.Tensor]:
    return [x for x in tree_flatten(tree)[0] if isinstance(x, torch.Tensor)]


def _storage(t: torch.Tensor):
    # a DTensor (a stage on a mesh) shares its shard's storage
    t = getattr(t, "_local_tensor", t)
    if not t.numel() or t.device.type == "meta":  # meta: no storage to share
        return None
    return t.untyped_storage().data_ptr()


class Recorder(TorchDispatchMode):
    """Counts the work of the aten ops run inside it, and of the kernels
    ``kernels/ops.py`` declares (:meth:`declare`), by class.  Used as a
    context manager; :meth:`report` gives the reference's
    ``analyze_hlo_text`` keys."""

    def __init__(self):
        super().__init__()
        self.flops: Dict[str, float] = defaultdict(float)
        self.hbm: Dict[str, float] = defaultdict(float)
        self.count: Dict[str, int] = defaultdict(int)
        self._paused = 0

    def __enter__(self):
        _recorders.append(self)
        return super().__enter__()

    def __exit__(self, *exc):
        _recorders.pop()
        return super().__exit__(*exc)

    def add(self, cls: str, n_bytes: float, flops: float) -> None:
        if cls in ("DM", "TB", "EW"):
            self.flops[cls] += float(flops)
        self.hbm[cls] += float(n_bytes)
        self.count[cls] += 1

    @contextlib.contextmanager
    def declare(self, cls: str, n_bytes: float, flops: float):
        """A kernel call's declared work; the aten ops run inside (the
        wrapper's allocations, or the plain version on the CPU) are not
        counted."""
        self.add(cls, n_bytes, flops)
        self._paused += 1
        try:
            yield
        finally:
            self._paused -= 1

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        # an op with a composite kernel (matmul, einsum, reshape: what
        # inference mode hands over before autograd would decompose it) is
        # counted by the ops it decomposes into
        with self:
            out = func.decompose(*args, **kwargs)
        if out is not NotImplemented:
            return out
        out = func(*args, **kwargs)
        if not self._paused:
            self._count(func, args, kwargs, out)
        return out

    def _count(self, func, args, kwargs, out) -> None:
        schema = func._schema
        if any(r.alias_info is not None and not r.alias_info.is_write
               for r in schema.returns):
            return  # a view
        base = _base(func._overloadpacket.__name__)
        cls = op_class(f"{func.namespace}::{base}")
        results = _tensors(out)
        if cls == "ZERO" or not (results or base == "_local_scalar_dense"):
            return  # allocates, or reads metadata
        written = {a.name for a in schema.arguments
                   if a.alias_info is not None and a.alias_info.is_write}
        if not written:
            ins = {_storage(t) for t in _tensors((args, kwargs))} - {None}
            if results and all(_storage(t) in ins for t in results):
                return  # aliases an input without saying so
        if base in FILL_OPS:
            reads: List[torch.Tensor] = []  # a fill reads nothing
        else:
            named = dict(zip((a.name for a in schema.arguments), args))
            named.update(kwargs)
            reads = _tensors([v for k, v in named.items()
                              if k not in written])
        n_bytes = sum(map(_nbytes, reads)) + sum(map(_nbytes, results))
        elems = sum(t.numel() for t in results)
        flops = 0.0
        if cls == "DM":
            lhs = args[1] if base in ("addmm", "baddbmm", "addmv") \
                else args[0]
            flops = 2.0 * elems * lhs.shape[-1]
        elif cls in ("TB", "EW"):
            flops = float(elems)
        self.add(cls, n_bytes, flops)

    def report(self) -> Dict:
        flops = {k: float(v) for k, v in self.flops.items()}
        hbm = {k: float(v) for k, v in self.hbm.items()}
        return {"flops_by_class": flops, "hbm_bytes_by_class": hbm,
                "collective_bytes": 0.0, "op_counts": dict(self.count),
                "total_flops": float(sum(flops.values())),
                "total_hbm_bytes": float(sum(hbm.values()))}


@contextlib.contextmanager
def repeated(n: int):
    """Count what runs inside ``n`` times over, in every recorder in use
    (a loop whose ``n`` iterations do the same work on meta tensors runs
    one of them: the dry run's tile loops).  Without a recorder, a no-op."""
    snaps = [(r, {k: dict(getattr(r, k)) for k in ("flops", "hbm", "count")},
              getattr(r, "coll_bytes", 0.0)) for r in _recorders]
    try:
        yield
    finally:
        for r, snap, coll in snaps:
            for k in ("flops", "hbm", "count"):
                acc = getattr(r, k)
                for c, v in list(acc.items()):
                    acc[c] = snap[k].get(c, 0) + (v - snap[k].get(c, 0)) * n
            if hasattr(r, "coll_bytes"):
                r.coll_bytes = coll + (r.coll_bytes - coll) * n


def declared(cls: str, work: Callable[[], Tuple[float, float]], fn,
             *args, **kwargs):
    """Call the kernel wrapper ``fn``; under a recorder, count ``work()``
    (its ``(bytes, operations)``) as one ``cls`` op instead of the aten ops the
    call runs.  Without one, the cost is one check of an empty list."""
    if not _recorders:
        return fn(*args, **kwargs)
    with _recorders[-1].declare(cls, *work()):
        return fn(*args, **kwargs)


def roofline(per_device: Dict, n_chips: int, model_fl: float,
             dtype: torch.dtype = torch.float32) -> Dict:
    """The reference's roofline terms (``compute_s``, ``memory_s``,
    ``collective_s``, ``bound``, ...) at the H100's rates: the FLOPs at
    the peak of ``dtype`` (the HGNNs compute in fp32 with TF32 off: 67
    TFLOP/s), the bytes at 3.35 TB/s, the collective bytes over NVLink."""
    peak = PEAK_FLOPS[dtype]
    t_c = per_device["total_flops"] / peak
    t_m = per_device["total_hbm_bytes"] / HBM_BW
    t_l = per_device["collective_bytes"] / LINK_BW
    bound = max((t_c, "compute"), (t_m, "memory"), (t_l, "collective"))[1]
    t_step = max(t_c, t_m, t_l)
    model_fl_dev = model_fl / n_chips
    return {
        "compute_s": t_c,
        "memory_s": t_m,
        "collective_s": t_l,
        "bound": bound,
        "step_time_s": t_step,
        "model_flops_total": model_fl,
        "model_flops_per_device": model_fl_dev,
        "useful_flops_ratio": model_fl_dev / per_device["total_flops"]
        if per_device["total_flops"] else 0.0,
        "mfu_proxy": model_fl_dev / (t_step * peak) if t_step else 0.0,
        "roofline_fraction": (model_fl_dev / peak) / t_step if t_step else 0.0,
    }


# ---------------------------------------------------------------------------
# times on the card
# ---------------------------------------------------------------------------


TIME_REPS = 20  # calls a stage's time_us is the median of
PROFILE_REPS = 5  # profiled calls a stage's device_us is the mean of


def stage_time_us(fn: Callable[[], object]) -> float:
    """Median over :data:`TIME_REPS` calls (after 3 warm-ups) of CUDA
    events around ``fn()``, each
    call started on an idle device and synchronised: the stage as its
    caller waits for it, the device's idle gaps while the host issues its
    ops included."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(TIME_REPS):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) * 1e3)
    times.sort()
    return times[len(times) // 2]


def _attribute(events, windows):
    """``stage -> [(kernel name, duration, class)]`` for the device kernels
    of one profile.  A kernel's launch is the host's runtime call of the
    same correlation id (``cudaLaunchKernel``, ``cudaMemsetAsync``, ...):
    the window that holds the launch is its stage, and the innermost aten
    op that holds it classes the kernel, unless :func:`kernel_class` names
    it (the profiler's own link, ``FunctionEvent.kernels``, misses the
    kernels that cuBLAS launches by ``cudaLaunchKernelExC``).  A kernel
    with no such call goes to the window it starts in, classed by its name
    alone."""
    import bisect

    from torch.autograd import DeviceType

    host = [e for e in events if e.device_type == DeviceType.CPU]
    kernels = [e for e in events if e.device_type == DeviceType.CUDA
               and not e.name.startswith("stage::")]
    launch_at = {e.id: e.time_range.start for e in host
                 if e.name.startswith("cu")}
    ops = sorted((e.time_range.start, e.time_range.end, e.name)
                 for e in host if e.name.startswith("aten::"))
    op_starts = [o[0] for o in ops]

    def window_at(t):
        return next((n for t0, t1, n in windows if t0 <= t <= t1), None)

    def op_at(t):  # the latest-started aten op still open at t
        i = bisect.bisect_right(op_starts, t)
        while i > 0:
            i -= 1
            if ops[i][1] >= t:
                return ops[i][2]
        return None

    found: Dict[str, List[Tuple[str, float, str]]] = defaultdict(list)
    for e in kernels:
        dur = e.time_range.end - e.time_range.start
        t = launch_at.get(e.id)
        owner = window_at(t) if t is not None else None
        if owner is not None:
            op = op_at(t)
            cls = op_class(op) if op is not None else "OTHER"
        else:
            owner = windows[0][2]
            for t0, _, n in windows:
                if t0 <= e.time_range.start:
                    owner = n
            cls = "OTHER"
        found[owner].append((e.name, dur, kernel_class(e.name) or cls))
    return found


def device_times_us(calls: Dict[str, Callable[[], object]]
                    ) -> Dict[str, Tuple[float, Dict[str, float], List[str]]]:
    """Device time of one call of each stage (the mean over
    :data:`PROFILE_REPS` profiled calls), its split by class, and the names of the kernels left
    in OTHER: ``name -> (device_us, by_class, other)``.

    One ``torch.profiler`` session covers every stage, each in a
    ``record_function`` window of its own, synchronised at its end, the
    session padded with 50 ms of host time at both ends; kernels are
    attributed to stages and classes by :func:`_attribute`, on the host's
    clock.  A session in which a stage that runs ops shows no device
    kernel is a failed trace and is taken again, up to three times."""
    import time

    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function

    for fn in calls.values():
        fn()
    torch.cuda.synchronize()
    names = list(calls)
    seen = []
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            time.sleep(0.05)
            for name in names:
                with record_function(f"stage::{name}"):
                    for _ in range(PROFILE_REPS):
                        calls[name]()
                    torch.cuda.synchronize()
                time.sleep(2e-3)
            time.sleep(0.05)
        events = prof.events()
        windows = sorted((e.time_range.start, e.time_range.end,
                          e.name[len("stage::"):]) for e in events
                         if e.name.startswith("stage::")
                         and e.device_type == DeviceType.CPU)
        found = _attribute(events, windows) if windows else {}
        if len(windows) == len(names) and all(found.get(n) for n in names):
            break
        seen.append({"windows": len(windows), "kernels": {
            n: len(found.get(n, ())) for n in names}, "device events": sum(
                e.device_type == DeviceType.CUDA for e in events)})
        time.sleep(1.0)
    else:
        raise RuntimeError(f"three profiles of the stages {names} held no "
                           f"device kernel for a stage: {seen}")
    out = {}
    for name in names:
        by_class: Dict[str, float] = defaultdict(float)
        other = set()
        for kname, dur, cls in found[name]:
            if cls not in CLASSES or cls == "OTHER":
                cls = "OTHER"
                other.add(kname)
            by_class[cls] += dur
        out[name] = (sum(by_class.values()) / PROFILE_REPS,
                     {k: v / PROFILE_REPS for k, v in by_class.items()},
                     sorted(other))
    return out


# ---------------------------------------------------------------------------
# partitioned-execution traffic record
# ---------------------------------------------------------------------------


def _itemsize(x) -> int:
    return x.element_size() if isinstance(x, torch.Tensor) \
        else x.dtype.itemsize


def partition_traffic(part: Dict, h_own: Dict, layers: int = 1) -> Dict:
    """Halo-exchange / edge-cut record for the partitioned execution mode
    (the reference's, ``:369``).  ``part`` is the batch's partition table
    (``halo_mask`` per type and the host-side ``meta`` counters), ``h_own``
    the per-type ``[K, n, ...]`` feature shards entering the exchange,
    whose trailing dims price a halo row in bytes.  An L-layer stack
    re-runs the exchange once a layer: ``halo_bytes_total`` /
    ``halo_rows_total`` are the per-exchange figures times ``layers``."""
    import numpy as np

    halo_rows = 0.0
    halo_bytes = 0.0
    for t, m in part["halo_mask"].items():
        if hasattr(m, "full_tensor"):  # laid out on a mesh
            m = m.full_tensor()
        m = m.cpu().numpy() if isinstance(m, torch.Tensor) else m
        rows = float(np.asarray(m).sum())
        h = h_own[t]
        row_bytes = 1.0
        for d in h.shape[2:]:
            row_bytes *= d
        row_bytes *= _itemsize(h)
        halo_rows += rows
        halo_bytes += rows * row_bytes
    meta = part["meta"]
    cut = int(meta["cut_edges"])
    total = int(meta["edges_total"])
    return {
        "k": int(meta["k"]),
        "halo_rows": halo_rows,
        "halo_bytes": halo_bytes,
        "cut_edges": cut,
        "edges_total": total,
        "cut_ratio": cut / max(total, 1),
        "layers": int(layers),
        "halo_rows_total": halo_rows * layers,
        "halo_bytes_total": halo_bytes * layers,
    }


# ---------------------------------------------------------------------------
# request-path sampled-serving traffic record
# ---------------------------------------------------------------------------


def sample_traffic(meta: Dict) -> Dict:
    """SAMPLE-stage record for request-path serving (the reference's,
    ``:420``): the sampler's host-side batch metadata, the frontier rows
    fetched beyond the targets (``frontier_bytes``) and the relabeled index
    tables shipped to the device (``index_bytes``)."""
    return {
        "rung": list(meta["rung"]),
        "rung_index": int(meta["rung_index"]),
        "n_targets": int(meta["n_targets"]),
        "frontier_rows": int(meta["frontier_rows"]),
        "frontier_bytes": float(meta["frontier_bytes"]),
        "index_bytes": float(meta["index_bytes"]),
        "truncated_rows": int(meta["truncated_rows"]),
        "fanout": int(meta["fanout"]),
    }


def residency_record(counters: Dict, row_bytes: int, layers: int = 1) -> Dict:
    """Hot-feature residency record (the reference's, ``:443``).
    ``counters`` are the deterministic hit/miss counters of a prepared
    batch, ``row_bytes`` prices one gathered feature row, ``layers`` is the
    number of cached stages.  The hot set is layer-invariant, so every
    layer saves ``hits × row_bytes`` of gather traffic while the cache fill
    (``cache_rows × row_bytes``) is paid once."""
    hits = int(counters["hits"])
    misses = int(counters["misses"])
    rows = int(counters["rows"])
    cache_rows = int(counters["cache_rows"])
    fill = cache_rows * int(row_bytes)
    per_layer = hits * int(row_bytes)
    return {
        "cache_rows": cache_rows,
        "hits": hits,
        "misses": misses,
        "rows": rows,
        "hit_rate": hits / max(rows, 1),
        "row_bytes": int(row_bytes),
        "layers": int(layers),
        "fill_bytes": fill,
        "bytes_saved_per_layer": per_layer,
        "bytes_saved_total": per_layer * int(layers) - fill,
    }


def resilience_record(stats: Dict) -> Dict:
    """Resilience counters record for request-path serving (the
    reference's, ``:477``): per-status request counts, retry and failure
    totals, the degradation trajectory and the partition-failover outcome,
    flattened from a serving engine's ``stats()``."""
    rs = stats.get("resilience", {})
    return {
        "ok_requests": int(rs.get("ok_requests", 0)),
        "partial_requests": int(rs.get("partial_requests", 0)),
        "failed_requests": int(rs.get("failed_requests", 0)),
        "rejected": int(rs.get("rejected", 0)),
        "shed": int(rs.get("shed", 0)),
        "deduped_rows": int(rs.get("deduped_rows", 0)),
        "retries": int(rs.get("retries", 0)),
        "failed_steps": int(rs.get("failed_steps", 0)),
        "deadline_expired": int(rs.get("deadline_expired", 0)),
        "degrade_transitions": int(rs.get("degrade_transitions", 0)),
        "recover_transitions": int(rs.get("recover_transitions", 0)),
        "max_degrade_level": int(rs.get("max_degrade_level", 0)),
        "partition_failovers": int(rs.get("partition_failovers", 0)),
        "lost_partitions": list(rs.get("lost_partitions", [])),
        "steps": int(stats.get("steps", 0)),
        "recompiles": stats.get("compiles_after_warmup"),
    }


# ---------------------------------------------------------------------------
# async stage-graph overlap accounting
# ---------------------------------------------------------------------------


def overlap_accounting(edges: Dict[str, Tuple[str, ...]],
                       walls_us: Dict[str, float]) -> Dict:
    """Critical-path accounting over a stage DAG (the reference's,
    ``:515``).  ``edges`` maps each stage to its dependencies in
    topological order, ``walls_us`` the measured per-stage walls.  The
    serial sum is the blocking schedule's time, the critical path the
    overlapped schedule's; a stage's exposure is the critical path less
    the critical path with that stage's wall zeroed."""
    finish: Dict[str, float] = {}
    for n in edges:  # topological by construction
        finish[n] = (max((finish[d] for d in edges[n]), default=0.0)
                     + walls_us.get(n, 0.0))
    crit = max(finish.values(), default=0.0)

    def _crit_without(skip: str) -> float:
        f: Dict[str, float] = {}
        for n in edges:
            w = 0.0 if n == skip else walls_us.get(n, 0.0)
            f[n] = max((f[d] for d in edges[n]), default=0.0) + w
        return max(f.values(), default=0.0)

    serial = float(sum(walls_us.get(n, 0.0) for n in edges))
    return {
        "serial_sum_us": serial,
        "critical_path_us": float(crit),
        "overlap_saved_us": float(serial - crit),
        "exposure_us": {n: float(crit - _crit_without(n)) for n in edges},
    }


# ---------------------------------------------------------------------------
# the LM records: parameter counts, model FLOPs, one rank of a sharded step
# ---------------------------------------------------------------------------


def analytic_param_counts(cfg) -> Tuple[float, float]:
    """``(total params, active params)`` of a config, from a meta-device
    init (no storage); the active count takes ``top_k / n_experts`` of the
    expert weights (``w_gate`` / ``w_up`` / ``w_down`` under ``moe``)."""
    import math

    from repro_torch import tree
    from repro_torch.launch.steps import _params_abstract

    params = _params_abstract(cfg)
    total = expert = 0.0

    def visit(path, leaf):
        nonlocal total, expert
        n = float(math.prod(leaf.shape))
        total += n
        names = [k.key for k in path if isinstance(k, tree.DictKey)]
        if "moe" in names and names[-1] in ("w_gate", "w_up", "w_down"):
            expert += n

    tree.map_with_path(visit, params)
    active = total - expert
    if cfg.moe is not None and expert > 0:
        active += expert * cfg.moe.top_k / cfg.moe.n_experts
    return total, active


def model_flops(cfg, shape, n_total: float, n_active: float) -> float:
    """MODEL_FLOPS: ``6·N·D`` to train (``N`` active for a MoE), ``2·N·D``
    forward; a decode step makes one token a sequence."""
    if shape.kind == "train":
        return 6.0 * n_active * shape.global_batch * shape.seq_len
    if shape.kind == "prefill":
        return 2.0 * n_active * shape.global_batch * shape.seq_len
    return 2.0 * n_active * shape.global_batch


class MeshRecorder(Recorder):
    """A :class:`Recorder` of one rank's work on a mesh: an op on DTensors
    is handed back to DTensor (``NotImplemented``, as ``CommDebugMode``
    does), which runs it as local ops and collectives on this rank's
    shards, and those are what is counted.  A collective's result bytes
    are its collective bytes (the reference's HLO rule), kept apart from
    the HBM bytes."""

    def __init__(self):
        super().__init__()
        self.coll_bytes = 0.0
        self.coll_ops: Dict[str, float] = defaultdict(float)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch._subclasses.fake_tensor import FakeTensor
        from torch.distributed.tensor import DTensor

        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented
        if any(issubclass(t, FakeTensor) for t in types):
            # DTensor's sharding propagation computing shapes: no work
            return func(*args, **(kwargs or {}))
        return super().__torch_dispatch__(func, types, args, kwargs)

    def _count(self, func, args, kwargs, out) -> None:
        name = f"{func.namespace}::{func._overloadpacket.__name__}"
        if op_class(name) != "COLL":
            return super()._count(func, args, kwargs, out)
        if any(r.alias_info is not None and not r.alias_info.is_write
               for r in func._schema.returns):
            return  # wait_tensor: the collective was counted at its start
        n = float(sum(map(_nbytes, _tensors(out))))
        self.coll_bytes += n
        self.coll_ops[_base(name)] += n
        self.count["COLL"] += 1

    def report(self) -> Dict:
        rep = super().report()
        rep["collective_bytes"] = self.coll_bytes
        rep["collective_bytes_by_op"] = dict(self.coll_ops)
        return rep


def _local_bytes(values) -> int:
    """Bytes of this rank's shards of the tensors in ``values``."""
    total = 0
    for x in _tensors(values):
        loc = x.to_local() if hasattr(x, "to_local") else x
        total += _nbytes(loc)
    return total


def analyze_step(built, cfg=None, shape=None, mesh=None) -> Dict:
    """One rank's record of a built step (``launch/steps.build_step``) on
    ``mesh`` (a mesh with a ``DeviceMesh``; the dry run's is over the
    fake process group): the step's meta inputs laid out by its
    ``in_shardings``, the step run and its outputs laid out by its
    ``out_shardings`` inside a :class:`MeshRecorder`.  Keys: the
    recorder's (``total_flops``, ``total_hbm_bytes``, ``collective_bytes``,
    by class and by op), ``argument_bytes`` / ``output_bytes`` (this
    rank's shards of the inputs and outputs), ``roofline`` at the H100's
    rates (``cfg.dtype``'s peak), with ``params_total`` / ``params_active``
    and the model FLOPs when ``cfg`` and ``shape`` are given."""
    from repro_torch.dist.sharding import distribute_tree

    n_chips = mesh.size if mesh is not None else 1
    args = tuple(distribute_tree(a, s) for a, s in zip(built.in_specs,
                                                        built.in_shardings))
    rec = MeshRecorder()
    with torch.no_grad() if shape is not None and shape.kind != "train" \
            else contextlib.nullcontext():
        with rec:
            out = distribute_tree(built.fn(*args), built.out_shardings)
    rep = rec.report()
    rep["argument_bytes"] = float(_local_bytes(args))
    rep["output_bytes"] = float(_local_bytes(out))
    record = {"per_device": rep}
    dtype = torch.float32
    mf = 0.0
    if cfg is not None:
        dtype = getattr(torch, cfg.dtype)
        if shape is not None:
            n_total, n_active = analytic_param_counts(cfg)
            mf = model_flops(cfg, shape, n_total, n_active)
            record["params_total"] = n_total
            record["params_active"] = n_active
    record["roofline"] = roofline(rep, n_chips, mf,
                                  dtype=dtype if dtype in PEAK_FLOPS
                                  else torch.float32)
    return record
