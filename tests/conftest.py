"""Shared fixtures. NOTE: no XLA_FLAGS here — smoke tests must see 1 device;
multi-device tests spawn subprocesses (tests/test_dist.py).

If ``hypothesis`` is unavailable (minimal CI image), a deterministic stub
covering the subset these tests use (integers / sampled_from strategies,
``given``/``settings``) is installed so property tests still run — each
``@given`` sweeps ``max_examples`` seeded draws instead of failing at import.
"""
import functools
import inspect
import sys
import types

import numpy as np
import pytest
import scipy.sparse as sp

from repro.core.hgraph import HeteroGraph


def _install_hypothesis_stub() -> None:
    try:
        import hypothesis  # noqa: F401
        return
    except ModuleNotFoundError:
        pass

    class _Strategy:
        def __init__(self, draw):
            self.draw = draw

    strategies = types.ModuleType("hypothesis.strategies")
    strategies.integers = lambda lo, hi: _Strategy(
        lambda rng: int(rng.integers(lo, hi + 1)))
    strategies.sampled_from = lambda seq: _Strategy(
        lambda rng: seq[int(rng.integers(0, len(seq)))])
    strategies.booleans = lambda: _Strategy(lambda rng: bool(rng.integers(0, 2)))
    strategies.floats = lambda lo, hi: _Strategy(
        lambda rng: float(rng.uniform(lo, hi)))

    def given(**strats):
        def deco(fn):
            @functools.wraps(fn)
            def wrapper(*args, **kwargs):
                rng = np.random.default_rng(0)
                for _ in range(getattr(wrapper, "_max_examples", 10)):
                    draws = {k: s.draw(rng) for k, s in strats.items()}
                    fn(*args, **draws, **kwargs)
            # hide the drawn params from pytest's fixture resolution
            sig = inspect.signature(fn)
            wrapper.__signature__ = sig.replace(parameters=[
                p for name, p in sig.parameters.items() if name not in strats])
            del wrapper.__wrapped__
            return wrapper
        return deco

    def settings(max_examples=10, **_kw):
        def deco(fn):
            fn._max_examples = max_examples
            return fn
        return deco

    mod = types.ModuleType("hypothesis")
    mod.strategies = strategies
    mod.given = given
    mod.settings = settings
    sys.modules["hypothesis"] = mod
    sys.modules["hypothesis.strategies"] = strategies


_install_hypothesis_stub()


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "gpu: needs a CUDA device; skips without one")


@pytest.fixture(scope="session")
def tiny_hg() -> HeteroGraph:
    """Small deterministic bipartite-ish HG (movie/director/actor style)."""
    rng = np.random.default_rng(7)
    counts = {"M": 40, "D": 15, "A": 25}
    dims = {"M": 12, "D": 8, "A": 10}
    feats = {t: rng.standard_normal((n, dims[t])).astype(np.float32)
             for t, n in counts.items()}

    def rand_rel(ns, nd, e):
        r = rng.integers(0, ns, e)
        c = rng.integers(0, nd, e)
        return sp.csr_matrix((np.ones(e, np.float32), (r, c)), shape=(ns, nd))

    md = rand_rel(40, 15, 60)
    ma = rand_rel(40, 25, 80)
    g = HeteroGraph(
        counts, feats,
        {("M", "md", "D"): md, ("D", "dm", "M"): md.T.tocsr(),
         ("M", "ma", "A"): ma, ("A", "am", "M"): ma.T.tocsr()},
        name="tiny")
    g.validate()
    return g


@pytest.fixture(scope="session")
def tiny_cfg_base():
    return dict(n_layers=2, d_model=32, n_heads=4, n_kv_heads=2, d_ff=64,
                vocab=101, dtype="float32", param_dtype="float32",
                remat="full", attn_chunk=16)
