#!/usr/bin/env python3
"""Where a served step's host time goes on the card, the compiled engine
(``graphs.compiled``: pinned staging, one graph replay) against the eager
one (``fn=executor.forward``: pageable ``place``, the eager forward).

    python3 scripts/torch_serve_host_profile.py [--requests 1024]

HAN/imdb (the fused epilogue), RGCN/imdb on 3 degree buckets and
MAGNN/imdb at fan-out 8, 8 slots of 4 targets (``chip_smoke.py`` phase
3m's configs and request count).  Per model:

* the host copy of a freshly sampled batch (each timed copy gets a batch
  the sampler has just made, as a served step does): into pinned staging
  by ``Tensor.copy_`` (which runs on the intra-op threads), into the
  same staging by ``numpy.copyto`` (one thread; what ``graphs.compiled``
  does), and the pageable ``torch.as_tensor(x, device=...)`` of the
  eager engine's ``place``, with the sampler call timed after each;
* both engines serving the same request queue in turns (eager,
  compiled, compiled, eager); for each serve the step wall p50 and p99,
  ``sample_s`` and ``forward_s`` (upload, forward and read-back) p50, the
  targets a second, and the Python garbage collector's pauses in the
  serve (count and ms, from ``gc.callbacks``);
* the spans of a compiled call in those serves, p50 ms a step: the wait
  for the last upload out of staging, the host copies into staging (the
  leaves not in pinned memory), the ``non_blocking`` copies queued, the
  wait for those straight from the sampler's pinned tables, the replay
  queued, the outputs copied (``result``), the rest of the call
  (signature, checks), and the read-back after it (``forward_s`` less
  the call: the wait for the card);
* a last compiled serve under cProfile, its top host functions by own
  time.

Prints the card's name and power limit first.  Needs a CUDA device.
"""
import argparse
import cProfile
import gc
import io
import os
import pstats
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def ms(xs, q):
    import numpy as np

    return float(np.percentile(np.asarray(xs) * 1e3, q))


class GcPauses:
    """The collector's pauses while in the ``with`` block."""

    def __enter__(self):
        self.n, self.s, self._t = 0, 0.0, None
        gc.callbacks.append(self._cb)
        return self

    def _cb(self, phase, info):
        if phase == "start":
            self._t = time.perf_counter()
        elif self._t is not None:
            self.n += 1
            self.s += time.perf_counter() - self._t

    def __exit__(self, *exc):
        gc.callbacks.remove(self._cb)


SPANS = ("wait", "host copy", "queue copies", "copy wait", "replay",
         "result", "rest", "read-back")
MIB = {}  # the last upload's MiB copied straight from pinned and staged


def timed_spans(graphs):
    """Wrap ``graphs``' upload, replay and result (and the call) with
    timers; returns the per-call span lists, keyed as ``SPANS``."""
    import numpy as np
    import torch

    spans = {k: [] for k in SPANS + ("call",)}
    cur: dict = {}

    def upload(self, flat):
        """``_Graph.upload`` with its spans timed (the same steps)."""
        if not self.uploads:
            return
        t0 = time.perf_counter()
        self._done.synchronize()
        t1 = time.perf_counter()
        direct, staged = [], []
        with torch.inference_mode(False):
            for up in self.uploads:
                x = flat[up[0]]
                src = torch.from_numpy(x) if isinstance(x, np.ndarray) else x
                (direct if graphs._card.pinned(src) else staged).append(
                    (up, src))
            for up, src in staged:
                if up[1] is None:
                    up[1] = graphs._card.staging(tuple(up[2].shape),
                                                 up[2].dtype)
                up[1].copy_(src)
            t2 = time.perf_counter()
            for up, src in direct:
                up[2].copy_(src, non_blocking=True)
            for up, _ in staged:
                up[2].copy_(up[1], non_blocking=True)
        self._done.record()
        t3 = time.perf_counter()
        if direct:
            self._done.synchronize()
        t4 = time.perf_counter()
        cur.update({"wait": t1 - t0, "host copy": t2 - t1,
                    "queue copies": t3 - t2, "copy wait": t4 - t3})
        MIB["direct"] = sum(s.numel() * s.element_size()
                            for _, s in direct) / 2 ** 20
        MIB["staged"] = sum(s.numel() * s.element_size()
                            for _, s in staged) / 2 ** 20

    replay, result = graphs._Card.replay, graphs._Graph.result

    def timed_replay(self, g):
        t0 = time.perf_counter()
        replay(g)
        cur["replay"] = time.perf_counter() - t0

    def timed_result(self, out, flat):
        t0 = time.perf_counter()
        r = result(self, out, flat)
        cur["result"] = time.perf_counter() - t0
        return r

    class Timed(graphs.Compiled):
        def __call__(self, *args):
            cur.clear()
            t0 = time.perf_counter()
            out = super().__call__(*args)
            call = time.perf_counter() - t0
            if "replay" in cur:
                spans["call"].append(call)
                for k in SPANS[:6]:
                    spans[k].append(cur.get(k, 0.0))
                spans["rest"].append(call - sum(cur.values()))
            return out

    graphs._Graph.upload = upload
    graphs._Card.replay = timed_replay
    graphs._Graph.result = timed_result
    return spans, Timed


def host_copies(sampler, ids_of, dev, n=20):
    """Median ms of each way to copy a fresh sampled batch off the host,
    and of the sampler call that follows each copy."""
    import numpy as np
    import torch
    from repro_torch import tree

    def fresh():
        return sampler.sample(ids_of()).batch

    leaves = [x for x in tree.leaves(fresh())
              if isinstance(x, (np.ndarray, torch.Tensor))]
    pins = [torch.empty(tuple(x.shape), dtype=torch.as_tensor(x).dtype,
                        pin_memory=True) for x in leaves]

    def arrays(batch):
        return [x if isinstance(x, np.ndarray) else x.numpy()
                for x in tree.leaves(batch)
                if isinstance(x, (np.ndarray, torch.Tensor))]

    ways = {
        "Tensor.copy_ into pinned": lambda xs: [
            p.copy_(torch.from_numpy(x)) for p, x in zip(pins, xs)],
        "numpy.copyto into pinned": lambda xs: [
            np.copyto(p.numpy(), x) for p, x in zip(pins, xs)],
        "pageable as_tensor to the card": lambda xs: [
            torch.as_tensor(x, device=dev) for x in xs],
    }
    out = {}
    for name, way in ways.items():
        copy, sample = [], []
        for _ in range(n):
            xs = arrays(fresh())
            if len(xs) != len(pins) or any(
                    x.shape != tuple(p.shape) for x, p in zip(xs, pins)):
                continue  # another rung
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            way(xs)
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            fresh()
            sample.append(time.perf_counter() - t1)
            copy.append(t1 - t0)
        out[name] = (ms(copy, 50), ms(sample, 50), len(copy))
    mib = sum(p.numel() * p.element_size() for p in pins) / 2 ** 20
    return mib, len(pins), out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--requests", type=int, default=1024)
    args = ap.parse_args()
    sys.path.insert(0, os.path.join(ROOT, "src"))
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("no CUDA device: this script measures the card", file=sys.stderr)
        return 1
    from repro_torch import graphs
    from repro_torch.configs.base import HGNNConfig
    from repro_torch.data.synthetic import make_dataset
    from repro_torch.kernels import build
    from repro_torch.launch.serve import build_hgnn_infer, request_queue
    from repro_torch.serve.engine import HGNNServeEngine
    from repro_torch.serve.sampler import HGNNSampler

    torch.backends.cuda.matmul.allow_tf32 = False
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip())
    print(f"torch {torch.__version__}, intra-op threads "
          f"{torch.get_num_threads()}, host cores {os.cpu_count()}")
    build.library()
    spans, Timed = timed_spans(graphs)
    hg = make_dataset("imdb")
    dev = torch.device("cuda")
    for tag, cfg in (
            ("han/imdb", HGNNConfig(
                model="han", dataset="imdb", fused=True, use_pallas=True,
                fuse_na_sa=True, fanout=8)),
            ("rgcn/imdb bucketed 3", HGNNConfig(
                model="rgcn", dataset="imdb", fused=True, use_pallas=True,
                degree_buckets=3, fanout=8)),
            ("magnn/imdb", HGNNConfig(model="magnn", dataset="imdb",
                                      use_pallas=True, fanout=8))):
        b = build_hgnn_infer(cfg, hg, dev)
        sampler = HGNNSampler(b.plan, cfg, hg)
        rng = np.random.default_rng(0)
        n_t = sampler.n_target_type
        mib, n_leaves, copies = host_copies(
            sampler, lambda: rng.choice(n_t, 32, replace=False), dev)
        print(f"{tag}: a fresh 32-target batch ({mib:.2f} MiB in {n_leaves} "
              f"arrays), median ms [copy, the sampler call after it] of "
              f"{min(c[2] for c in copies.values())}+ batches: "
              + "; ".join(f"{k} {c[0]:.3f}, {c[1]:.3f}"
                          for k, c in copies.items()), flush=True)
        engines = {arm: HGNNServeEngine(b.executor, b.params, sampler,
                                        slots=8, slot_targets=4, fn=fn)
                   for arm, fn in (("compiled", b.fn),
                                   ("eager", b.executor.forward))}
        engines["compiled"].fn.__class__ = Timed
        for e in engines.values():
            e.warmup()
            e.serve(request_queue(n_t, 4, 64))
        for arm in ("eager", "compiled", "compiled", "eager"):
            e = engines[arm]
            for v in spans.values():
                v.clear()
            reqs = request_queue(n_t, 4, args.requests)
            n_targets = sum(len(r.targets) for r in reqs)
            torch.cuda.synchronize()
            with GcPauses() as pauses:
                t0 = time.perf_counter()
                e.serve(reqs)
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
            log = e.step_log
            walls = [x["wall_s"] for x in log]
            print(f"{tag} {arm}: {len(log)} steps, step p50 "
                  f"{ms(walls, 50):.3f} p99 {ms(walls, 99):.3f} ms; "
                  f"sample_s p50 {ms([x['sample_s'] for x in log], 50):.3f},"
                  f" forward_s p50 "
                  f"{ms([x['forward_s'] for x in log], 50):.3f} ms; "
                  f"{n_targets / wall:.1f} targets/s; gc {pauses.n} pauses "
                  f"{pauses.s * 1e3:.2f} ms", flush=True)
            if arm != "eager":
                spans["read-back"] = [
                    x["forward_s"] - c for x, c in zip(log, spans["call"])]
                print(f"{tag} {arm}: spans of a call, p50 ms a step: "
                      + ", ".join(f"{k} {ms(spans[k], 50):.3f}"
                                  for k in SPANS + ("call",))
                      + f" (the last step's upload: {MIB['direct']:.2f} MiB "
                      f"straight from pinned, {MIB['staged']:.2f} MiB "
                      "staged)", flush=True)
        e = engines["compiled"]
        prof = cProfile.Profile()
        prof.enable()
        e.serve(request_queue(n_t, 4, args.requests))
        prof.disable()
        s = io.StringIO()
        pstats.Stats(prof, stream=s).sort_stats("tottime").print_stats(8)
        print("\n".join(line for line in s.getvalue().splitlines()[6:]
                        if line.strip()), flush=True)
        del engines, b
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
