"""The hot-row cache gather of the port (``kernels/feature_cache.py``,
``kernels/ref.py``, ``ops.cached_gather``) against the reference: the JAX
oracle ``ref.cached_gather`` and the Pallas kernel in interpret mode, as
``tests/test_residency.py`` runs it.

The function moves rows and computes nothing, so every comparison is
bitwise.  The CUDA kernel itself runs only on a card
(``tests/test_torch_kernels_gpu.py``)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import feature_cache as jfc
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.kernels import feature_cache as tfc
from repro_torch.kernels import ops, ref


def _case(seed, n, d, c, shape, where="mixed"):
    """``table [n, d]``, ``hot [c]`` distinct rows, ``idx`` of ``shape`` in
    ``[0, n+c)``: every index hot, every index cold, or mixed."""
    rng = np.random.default_rng(seed)
    table = rng.standard_normal((n, d)).astype(np.float32)
    hot = rng.permutation(n)[:c].astype(np.int32)
    lo, hi = {"hot": (n, n + c), "cold": (0, n), "mixed": (0, n + c)}[where]
    idx = rng.integers(lo, hi, shape).astype(np.int32)
    return table, hot, idx


CASES = [  # (n, d, c, idx shape, where)
    (50, 16, 1, (37, 4), "mixed"),  # C = 1
    (40, 8, 6, (129,), "hot"),  # every index hot; not a multiple of 128
    (40, 8, 6, (20, 7), "cold"),  # every index cold
    (300, 64, 32, (130, 16), "mixed"),  # MAGNN's shape, cut down
    (25, 3, 4, (11, 5), "mixed"),  # D not a multiple of 4
]


def _oracles(table, hot, idx):
    jt, jh, ji = jnp.asarray(table), jnp.asarray(hot), jnp.asarray(idx)
    return (np.asarray(jref.cached_gather(jt, jh, ji)),
            np.asarray(jfc.cached_gather(jt, jh, ji, interpret=True)))


@pytest.mark.parametrize("case", CASES)
def test_plain_and_emulation_are_bitwise_the_jax_ref_and_pallas(case):
    table, hot, idx = _case(1, *case)
    t, h, i = map(torch.from_numpy, (table, hot, idx))
    plain = ref.cached_gather(t, h, i).numpy()
    emu = tfc.cached_gather_emulate(t, h, i).numpy()
    for want in _oracles(table, hot, idx):
        assert want.shape == plain.shape == idx.shape + (table.shape[1],)
        assert plain.tobytes() == want.tobytes()
        assert emu.tobytes() == want.tobytes()


@pytest.mark.parametrize("c", [1, 45])
def test_emulation_reads_hot_rows_from_the_table(c):
    """No cache is filled: a hot index reads ``table[hot[idx - N]]``.  With
    one hot row and with every row hot (C = N, a permutation, so no id
    repeats), including the hot id N - 1, it is bitwise the JAX oracle and
    the Pallas kernel, which gather from the filled pool."""
    n = 45
    table, _, idx = _case(8, n, 16, c, (29, 6), "mixed")
    hot = np.random.default_rng(9).permutation(n)[:c].astype(np.int32)
    if c == 1:
        hot[0] = n - 1
    assert len(set(hot.tolist())) == c and (n - 1) in hot
    idx[0, :] = n + hot.tolist().index(n - 1)  # the slot of hot id N - 1
    t, h, i = map(torch.from_numpy, (table, hot, idx))
    emu = tfc.cached_gather_emulate(t, h, i).numpy()
    for want in _oracles(table, hot, idx):
        assert emu.tobytes() == want.tobytes()
    assert emu[0, 0].tobytes() == table[n - 1].tobytes()


def test_strided_index_views_are_bitwise_the_jax_ref():
    """One position of a MAGNN instance table ``nodes[:, :, j]`` is a view
    with a column stride of L; the port gathers through it as it is."""
    table, hot, _ = _case(2, 60, 16, 8, (1,))
    rng = np.random.default_rng(3)
    nodes = rng.integers(0, 68, (23, 5, 3)).astype(np.int32)
    t, h, tn = map(torch.from_numpy, (table, hot, nodes))
    for j in range(3):
        view = tn[:, :, j]
        assert not view.is_contiguous()
        want, pallas = _oracles(table, hot, np.ascontiguousarray(
            nodes[:, :, j]))
        for got in (ops.cached_gather(t, h, view, use_pallas=True),
                    ops.cached_gather(t, h, view, use_pallas=False),
                    tfc.cached_gather_emulate(t, h, view)):
            assert got.numpy().tobytes() == want.tobytes() == \
                pallas.tobytes()


def test_ops_cached_gather_matches_the_jax_ops_wrapper():
    table, hot, idx = _case(4, 70, 32, 10, (33, 6))
    want = np.asarray(jops.cached_gather(
        jnp.asarray(table), jnp.asarray(hot), jnp.asarray(idx),
        use_pallas=False))
    t, h, i = map(torch.from_numpy, (table, hot, idx))
    for use_pallas in (False, True):
        got = ops.cached_gather(t, h, i, use_pallas=use_pallas)
        assert got.numpy().tobytes() == want.tobytes()


def test_emulation_clamps_every_index_into_the_table_or_the_cache():
    """What the kernel does with an index outside ``[0, N+C)``: a cache
    slot past the last is the last, a negative row is row 0."""
    table, hot, _ = _case(5, 10, 4, 3, (1,))
    t, h = torch.from_numpy(table), torch.from_numpy(hot)
    idx = torch.tensor([-4, 0, 9, 10, 12, 13, 1 << 30], dtype=torch.int32)
    got = tfc.cached_gather_emulate(t, h, idx)
    rows = [t[0], t[0], t[9], t[hot[0]], t[hot[2]], t[hot[2]], t[hot[2]]]
    assert torch.equal(got, torch.stack(rows))


def test_wrapper_on_cpu_runs_plain_and_counts_nothing():
    table, hot, idx = _case(6, 30, 8, 4, (9, 3))
    t, h, i = map(torch.from_numpy, (table, hot, idx))
    ops.reset_launch_counts()
    assert torch.equal(tfc.cached_gather(t, h, i),
                       tfc.cached_gather_plain(t, h, i))
    assert ops.launch_counts()["cached_gather"] == 0


def _meta(n=4278, d=64, c=256, idx_shape=(4278, 16), **over):
    """Meta tensors at one MAGNN/imdb instance position's shapes."""
    a = dict(table=torch.empty((n, d), device="meta"),
             hot=torch.empty((c,), dtype=torch.int32, device="meta"),
             idx=torch.empty(idx_shape + (3,), dtype=torch.int32,
                             device="meta")[..., 1])
    a.update(over)
    return a


def test_kernel_args_accept_the_main_path_shapes():
    args = _meta()
    assert not args["idx"].is_contiguous()  # a strided position view
    tfc.check_kernel_args(**args)
    tfc.check_kernel_args(**_meta(idx=torch.empty(
        (7,), dtype=torch.int32, device="meta")))


@pytest.mark.parametrize("over,match", [
    (dict(table=torch.empty((10, 4), dtype=torch.float64, device="meta")),
     "float32"),
    (dict(hot=torch.empty((3,), dtype=torch.int64, device="meta")), "int32"),
    (dict(idx=torch.empty((4, 2, 2), dtype=torch.int32, device="meta")),
     "idx \\[R\\]"),
    (dict(table=torch.empty((4, 10), device="meta").t()), "contiguous"),
    (dict(hot=torch.empty((0,), dtype=torch.int32, device="meta")), "empty"),
])
def test_kernel_args_reject_what_the_kernel_does_not_take(over, match):
    with pytest.raises(ValueError, match=match):
        tfc.check_kernel_args(**_meta(**over))


def test_wrapper_rejects_mixed_and_unknown_devices():
    table, hot, idx = _case(7, 10, 4, 2, (3,))
    t, h, i = map(torch.from_numpy, (table, hot, idx))
    with pytest.raises(ValueError, match="several devices"):
        tfc.cached_gather(t.to("meta"), h, i)
    with pytest.raises(ValueError, match="no kernel"):
        tfc.cached_gather(t.to("meta"), h.to("meta"), i.to("meta"))
