"""Checkpoint / restart (port of ``repro/train/checkpoint.py``, with the
reference's on-disk layout).

Layout (per checkpoint directory):
    step_<N>/
      manifest.json       step, n_leaves, shapes/dtypes, digest
      shard_<host>.npz    flattened leaves owned by this host

* atomic publish — written to ``step_<N>.tmp``, then ``os.rename`` (readers
  never observe a partial checkpoint);
* async save — a background thread drains a 1-deep queue, so training
  never blocks on disk;
* integrity — the shard's sha256 digest is checked on restore (``IOError``
  on a mismatch).

The leaves are numbered in ``jax.tree.leaves`` order
(``repro_torch/tree.py``): dict keys sorted, NamedTuple fields and list
items in order.  A checkpoint written by either package therefore has the
same leaf order, shapes and manifest dtypes, and the port restores the
reference's checkpoints.  A bf16 leaf is written as the reference's
``np.savez`` writes it: its raw 16-bit patterns as a ``|V2`` array, with
the manifest dtype ``bfloat16``.  The reference hands that ``|V2`` array to
``jax.numpy.asarray`` and fails (ROADMAP Queue 3 check (h)); the port
restores it from the manifest's dtype, viewing the 16-bit patterns as
``torch.bfloat16``, so a bf16 state restores bit for bit.

A state laid out on a mesh (DTensor leaves, ``train_step.
state_shardings``) is saved whole: each leaf is gathered
(``full_tensor``, a collective every rank of its mesh enters; a
replicated leaf is the rank's own copy), and the mesh's first rank writes
``shard_<host_id>``, the bytes of the same state saved off the mesh.  The
state must be laid out as ``state_shardings`` says, never ``Partial``
(a gather would sum it).  ``AsyncCheckpointer.submit`` gathers on the
caller's thread, before it queues the snapshot: no collective runs in
the worker.  ``restore(shardings=)`` is the reference's elastic restore:
every rank reads the file and lays each leaf out from its own copy onto
the target mesh (``dist.sharding.distribute_tree``), whatever mesh the
checkpoint was saved from; ``device=`` is the restore with no mesh.
"""
from __future__ import annotations

import hashlib
import json
import os
import queue
import shutil
import threading
from typing import Any, Optional

import numpy as np
import torch

from repro_torch import tree
from repro_torch.dist.sharding import distribute_tree, is_dtensor, whole
from repro_torch.interop import DeviceLike, resolve_device


def _whole(state):
    """``state`` with every DTensor leaf made whole on this rank (module
    docstring: a gather, or the rank's copy of a replicated leaf)."""
    return tree.map(lambda x: whole(x) if torch.is_tensor(x) else x, state)


def _writes(state) -> bool:
    """Whether this process writes ``state``'s checkpoint: off a mesh the
    caller always; on a mesh its first rank."""
    import torch.distributed as dist

    for x in tree.leaves(state):
        if is_dtensor(x):
            return dist.get_rank() == int(x.device_mesh.mesh.flatten()[0])
    return True


def _to_numpy(x) -> np.ndarray:
    """A leaf as the reference's ``np.asarray`` of it writes: a bf16 tensor
    as its raw 16-bit patterns (``|V2``)."""
    if not torch.is_tensor(x):
        return np.asarray(x)
    x = x.detach().cpu()
    if x.dtype == torch.bfloat16:
        return x.view(torch.int16).numpy().view(np.dtype("V2"))
    return x.numpy()


def _dtype_name(x, a: np.ndarray) -> str:
    if torch.is_tensor(x) and x.dtype == torch.bfloat16:
        return "bfloat16"
    return str(a.dtype)


def _digest(path: str) -> str:
    with open(path, "rb") as f:
        return hashlib.sha256(f.read()).hexdigest()


def save(state: Any, ckpt_dir: str, step: int, host_id: int = 0) -> str:
    """Write ``state`` as ``step_<step>`` (module docstring); on a mesh
    every rank of it calls this, for the gathers, and one writes.  Returns
    the checkpoint's directory."""
    final = os.path.join(ckpt_dir, f"step_{step:08d}")
    flat = tree.leaves(_whole(state))
    if not _writes(state):
        return final
    leaves = [_to_numpy(x) for x in flat]
    os.makedirs(ckpt_dir, exist_ok=True)
    tmp = final + ".tmp"
    os.makedirs(tmp, exist_ok=True)
    arrs = {f"leaf_{i:05d}": a for i, a in enumerate(leaves)}
    shard_path = os.path.join(tmp, f"shard_{host_id:05d}.npz")
    np.savez(shard_path, **arrs)
    manifest = {
        "step": step,
        "n_leaves": len(leaves),
        "shapes": [list(a.shape) for a in leaves],
        "dtypes": [_dtype_name(x, a) for x, a in zip(flat, leaves)],
        "digest": {str(host_id): _digest(shard_path)},
    }
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)  # atomic publish
    return final


def latest_step(ckpt_dir: str) -> Optional[int]:
    if not os.path.isdir(ckpt_dir):
        return None
    steps = [int(d.split("_")[1]) for d in os.listdir(ckpt_dir)
             if d.startswith("step_") and not d.endswith(".tmp")]
    return max(steps) if steps else None


def _to_tensor(a: np.ndarray, dtype: str, device: torch.device
               ) -> torch.Tensor:
    if dtype == "bfloat16":  # raw 16-bit patterns (|V2)
        bits = torch.from_numpy(np.array(a).view(np.int16))
        return bits.view(torch.bfloat16).to(device)
    return torch.from_numpy(np.array(a)).to(device)


def _mesh_device(shardings) -> torch.device:
    """The device of this rank on the mesh of ``shardings``' first
    ``NamedSharding``."""
    for s in tree.leaves(shardings):
        dm = getattr(getattr(s, "mesh", None), "device_mesh", None)
        if dm is not None:
            if dm.device_type == "cuda":
                return torch.device("cuda", torch.cuda.current_device())
            return torch.device(dm.device_type)
    raise ValueError("restore: shardings name no mesh with a DeviceMesh")


def restore(ckpt_dir: str, like: Any, step: Optional[int] = None,
            shardings: Any = None, device: DeviceLike = None,
            host_id: int = 0) -> Any:
    """Restore into the structure of ``like`` (a state tree), each leaf in
    the dtype the manifest records.  ``shardings``: a ``NamedSharding``
    tree matching ``like`` (``None`` leaves allowed): every rank lays each
    leaf out onto the target mesh from its own copy (elastic restore onto
    any mesh).  Else each leaf on ``device`` (the CUDA device unless the
    caller names one)."""
    if shardings is not None and device is not None:
        raise ValueError("restore: pass shardings= or device=, not both")
    device = (_mesh_device(shardings) if shardings is not None
              else resolve_device(device))
    if step is None:
        step = latest_step(ckpt_dir)
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {ckpt_dir}")
    d = os.path.join(ckpt_dir, f"step_{step:08d}")
    with open(os.path.join(d, "manifest.json")) as f:
        manifest = json.load(f)
    shard_path = os.path.join(d, f"shard_{host_id:05d}.npz")
    want = manifest["digest"].get(str(host_id))
    if want is not None and want != _digest(shard_path):
        raise IOError(f"checkpoint shard corrupt: {shard_path}")
    n = manifest["n_leaves"]
    flat_like = tree.leaves(like)
    if len(flat_like) != n:
        raise ValueError(f"restore: {n} leaves in {d}, the state has "
                         f"{len(flat_like)}")
    with np.load(shard_path) as data:
        arrays = [data[f"leaf_{i:05d}"] for i in range(n)]
    for a, l in zip(arrays, flat_like):
        if tuple(a.shape) != tuple(l.shape):
            raise ValueError(f"restore: leaf shape {a.shape} in {d}, the "
                             f"state has {tuple(l.shape)}")
    leaves = [_to_tensor(a, dt, device)
              for a, dt in zip(arrays, manifest["dtypes"])]
    state = tree.unflatten(like, leaves)
    if shardings is not None:
        state = distribute_tree(state, shardings)
    return state


class AsyncCheckpointer:
    """Background writer: ``submit`` returns once the state is copied to
    the host (a state on a mesh gathered there, on the caller's thread:
    every rank of the mesh submits, and only the writing rank queues); a
    single worker drains a 1-deep queue (a newer snapshot replaces a
    queued older one)."""

    def __init__(self, ckpt_dir: str, host_id: int = 0):
        self.ckpt_dir = ckpt_dir
        self.host_id = host_id
        self._q: "queue.Queue" = queue.Queue(maxsize=1)
        self._err: Optional[BaseException] = None
        self._worker = threading.Thread(target=self._run, daemon=True)
        self._worker.start()

    def _run(self):
        while True:
            item = self._q.get()
            if item is None:
                return
            state_host, step = item
            try:
                save(state_host, self.ckpt_dir, step, self.host_id)
            except Exception as e:  # noqa: BLE001 surfaced on submit/close
                self._err = e

    def submit(self, state: Any, step: int):
        if self._err:
            raise self._err
        state_whole = _whole(state)
        if not _writes(state):
            return
        snap = tree.map(lambda x: x.detach().to("cpu", copy=True)
                        if torch.is_tensor(x) else x, state_whole)
        try:
            self._q.put_nowait((snap, step))
        except queue.Full:  # drop the older queued snapshot
            try:
                self._q.get_nowait()
            except queue.Empty:
                pass
            self._q.put_nowait((snap, step))

    def close(self):
        self._q.put(None)
        self._worker.join()
        if self._err:
            raise self._err
