"""Build the port's CUDA kernels with ``nvcc`` and load them with ``ctypes``.

Every ``csrc/*.cu`` file has a plain C interface (no PyTorch headers), so
the build is one ``nvcc -c`` per source, all started together, then one
link into a shared library:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 \\
         -Xcompiler -fPIC -c csrc/<name>.cu        (one per source)
    nvcc -shared -o libreprotorch_<hash>.so *.o

It happens at the first launch on a CUDA tensor, into ``build/kernels/``
at the root of the checkout (listed in ``.gitignore``).  The library name
carries a hash of the sources and flags, so an edited source rebuilds and
an unchanged one loads at once.  ``ptxas -v`` output (registers, shared
memory, spills of every kernel) is kept in :data:`build_log`.

A failed build raises: there is no fallback to the plain versions.
"""
from __future__ import annotations

import contextlib
import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path
from typing import Dict, List, Optional

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]
CFLAGS = ARCH_FLAGS + ["-std=c++17", "-O3", "-Xcompiler", "-fPIC",
                       "-Xptxas", "-v"]

_P, _I, _L, _F = (ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
                  ctypes.c_float)
# C entry points: name -> (argtypes, restype)
SIGNATURES: Dict[str, tuple] = {
    "gat_na_launch": ([_P] * 13 + [_I] * 6 + [_P], _I),
    "gat_na_rows_per_block": ([], _I),
    "gat_na_max_features": ([], _I),
    "gat_na_smem_bytes": ([_I] * 3, _L),
    "semantic_combine_launch": ([_P, _P, _P, _I, _L, _P], _I),
    "segment_spmm_launch": ([_P] * 4 + [_I] * 4 + [_P], _I),
    "segment_spmm_geometry": ([_P], None),
    "segment_sum_launch": ([_P] * 6 + [_I] * 4 + [_P], _I),
    "segment_sum_hot_launch": ([_P] * 3 + [_I] + [_P] * 4 + [_I] * 4 + [_P],
                               _I),
    "segment_sum_long_edges": ([], _I),
    "fused_fp_na_launch": ([_P] * 7 + [_I] * 5 + [_P], _I),
    "fused_fp_na_slices": ([], _I),
    "fused_fp_na_rows": ([], _I),
    "cached_gather_launch": ([_P] * 4 + [_I] * 3 + [_L] * 5 + [_P], _I),
    "semantic_scores_launch": ([_P] * 7 + [_I] * 4 + [_P], _I),
    "semantic_scores_tile_rows": ([_I] * 4, _I),
    "semantic_scores_smem_bytes": ([_I] * 2, _L),
    "flash_attention_launch": ([_P] * 4 + [_I] * 8 + [_F, _I, _P], _I),
    "flash_attention_bf16_instruction": ([], ctypes.c_char_p),
    "decode_attention_launch": ([_P] * 8 + [_I] * 7 + [_F, _I, _P], _I),
    "repro_cuda_error_string": ([_I], ctypes.c_char_p),
}

build_log = ""  # ptxas -v output of the last build in this process
build_seconds = 0.0  # wall time of that build (0 when the library was cached)
_lib: Optional[ctypes.CDLL] = None
_scratch: Dict[tuple, "torch.Tensor"] = {}
# while a CUDA graph is captured: where the scratch buffers that it reads
# go, for the graph to keep (``keeping``)
_taken: Optional[List["torch.Tensor"]] = None
# things made at run time: library loads and new or grown scratch buffers
# (what the serve engine's ``compiles_after_warmup`` counts after warmup)
created = 0


def sources() -> List[Path]:
    return sorted(CSRC.glob("*.cu"))


def find_nvcc() -> str:
    for home in (os.environ.get("CUDA_HOME"), os.environ.get("CUDA_PATH"),
                 "/usr/local/cuda"):
        if home and (Path(home) / "bin" / "nvcc").exists():
            return str(Path(home) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found (looked in $CUDA_HOME, $CUDA_PATH, "
            "/usr/local/cuda and $PATH): the CUDA kernels cannot be built")
    return found


def _digest(srcs: List[Path]) -> str:
    h = hashlib.sha256(" ".join(CFLAGS).encode())
    for src in srcs:
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return h.hexdigest()[:16]


def _compile(srcs: List[Path], lib_path: Path) -> str:
    nvcc = find_nvcc()
    lib_path.parent.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=lib_path.parent) as tmp:
        objs = [Path(tmp) / (src.stem + ".o") for src in srcs]
        procs = [subprocess.Popen(
            [nvcc, *CFLAGS, "-c", str(src), "-o", str(obj)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            for src, obj in zip(srcs, objs)]
        logs = []
        for src, proc in zip(srcs, procs):
            out, _ = proc.communicate()
            logs.append(f"== {src.name}\n{out}")
            if proc.returncode != 0:
                for other in procs:
                    other.kill()
                    other.wait()
                raise RuntimeError(f"nvcc failed on {src.name}:\n{out}")
        tmp_lib = Path(tmp) / lib_path.name
        link = subprocess.run(
            [nvcc, *ARCH_FLAGS, "-shared", *map(str, objs), "-o",
             str(tmp_lib)], capture_output=True, text=True)
        if link.returncode != 0:
            raise RuntimeError(f"nvcc link failed:\n{link.stdout}{link.stderr}")
        os.replace(tmp_lib, lib_path)  # atomic: a reader never sees half
    return "\n".join(logs)


def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first use."""
    global _lib, build_log, build_seconds, created
    if _lib is not None:
        return _lib
    srcs = sources()
    lib_path = BUILD_DIR / f"libreprotorch_{_digest(srcs)}.so"
    if not lib_path.exists():
        t0 = time.perf_counter()
        build_log = _compile(srcs, lib_path)
        build_seconds = time.perf_counter() - t0
    lib = ctypes.CDLL(str(lib_path))
    for name, (argtypes, restype) in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = restype
    _lib = lib
    created += 1
    return lib


def device_of(what: str, tensors) -> "torch.device":
    """The one device that all of a kernel's input tensors lie on.  A
    DTensor raises: a kernel takes a rank's local shards, which
    ``dist.sharding.local`` hands it."""
    tensors = tuple(tensors)
    if any(type(t).__name__ == "DTensor" for t in tensors):
        raise TypeError(f"{what}: a DTensor reached the kernel wrapper; "
                        "call it on local shards (dist.sharding.local)")
    devs = {t.device for t in tensors}
    if len(devs) != 1:
        raise ValueError(f"{what}: inputs on several devices "
                         f"{sorted(map(str, devs))}")
    return devs.pop()


def scratch(what: str, numel: int, dtype, device, stream: int
            ) -> "torch.Tensor":
    """A buffer of at least ``numel`` elements kept for the launches of
    ``what`` on one stream, zero when it is allocated.  A kernel that
    counts in it sets its counters back to 0 before it ends, so the next
    launch finds them so; launches on one stream run in order, so two
    never share it at once.

    While the stream captures a CUDA graph (``graphs.compiled``) the
    buffer must exist already, at its size: the capture's eager warm-up on
    the same stream made it, and an allocation now raises.  The buffer
    goes to the list that :func:`keeping` names, which the graph holds: a
    later, larger buffer for the same key takes its place in the table,
    and the old one lives as long as a graph that reads it."""
    import torch

    global created
    key = (what, str(device), stream, dtype)
    buf = _scratch.get(key)
    if torch.cuda.is_available() and torch.cuda.is_current_stream_capturing():
        if buf is None or buf.numel() < numel:
            raise RuntimeError(
                f"{what}: a scratch buffer of {numel} elements would be "
                "allocated while the stream captures a CUDA graph; run the "
                "step once on the capture stream before capturing it")
        if _taken is None:
            raise RuntimeError(
                f"{what}: scratch read by a CUDA graph that keeps none; "
                "capture through graphs.compiled")
        if all(b is not buf for b in _taken):
            _taken.append(buf)
        return buf
    if buf is None or buf.numel() < numel:
        buf = torch.zeros(numel, dtype=dtype, device=device)
        _scratch[key] = buf
        created += 1
    return buf


@contextlib.contextmanager
def keeping(into: List["torch.Tensor"]):
    """The scratch buffers handed out while a graph is captured go to
    ``into``, which the graph keeps."""
    global _taken
    prev, _taken = _taken, into
    try:
        yield into
    finally:
        _taken = prev


def check(err: int, what: str) -> None:
    """Raise if a C launcher returned a CUDA error."""
    if err != 0:
        text = library().repro_cuda_error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA error {err} ({text}) at launch")
