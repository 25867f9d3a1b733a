"""The port's fixed-order segment sum (``kernels/segment_sum.py``: plain
version, emulation of the CUDA kernel's walk, the wrapper's CPU dispatch)
and the two ``csr`` stages built on it (``stages.mean_aggregate_csr``,
``stages.gat_aggregate_csr``) against ``jax.ops.segment_sum`` and the
reference's stages.

Tolerances: against JAX, atol = rtol = 1e-5 (XLA's scatter-add may sum in
another order).  The emulation is held bitwise to the plain version: both
add each segment's edges in edge order, one rounded add after another,
which is the order the CUDA kernel keeps (the GPU tests hold the kernel
bitwise to the plain version too)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import stages as ref_stages
from repro_torch.core import stages
from repro_torch.kernels import ops
from repro_torch.kernels import segment_sum as tss

TOL = dict(atol=1e-5, rtol=1e-5)


def _case(kind, seed=0):
    """(vals [E, C], seg [E] sorted, idx [E] into a [M, C] table, table, n)
    with empty segments, single-edge ones and one heavy one, and values of
    mixed magnitude so that the order of the sums shows in the bits."""
    rng = np.random.default_rng(seed)
    n, c, m = {"empty": (6, 3, 4), "single": (40, 8, 30),
               "heavy": (50, 64, 90), "wide": (7, 300, 20)}[kind]
    if kind == "empty":
        seg = np.zeros(0, np.int64)
    elif kind == "single":
        seg = rng.choice(n, 25, replace=False)  # each segment 0 or 1 edge
    else:
        seg = rng.integers(0, n, 400)
        seg = np.concatenate([seg, np.full(700, n // 2)])  # a heavy segment
        seg = seg[seg % 7 != 3]  # and empty ones
    seg = np.sort(seg).astype(np.int32)
    e = len(seg)
    scale = np.exp(rng.uniform(-6, 6, (e, 1)))
    vals = (rng.standard_normal((e, c)) * scale).astype(np.float32)
    table = (rng.standard_normal((m, c)) * 0.5).astype(np.float32)
    idx = rng.integers(0, m, e).astype(np.int32)
    return vals, seg, idx, table, n


KINDS = ["empty", "single", "heavy", "wide"]


@pytest.mark.parametrize("kind", KINDS)
def test_plain_sum_matches_jax(kind):
    vals, seg, _, _, n = _case(kind)
    want = np.asarray(jax.ops.segment_sum(jnp.asarray(vals), jnp.asarray(seg),
                                          num_segments=n))
    got = tss.segment_sum_plain(torch.from_numpy(vals), torch.from_numpy(seg),
                                n)
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    empty = np.setdiff1d(np.arange(n), seg)
    assert (got.numpy()[empty] == 0).all()


@pytest.mark.parametrize("kind", KINDS)
def test_plain_mean_matches_reference_stage(kind):
    _, seg, idx, table, n = _case(kind)
    want = np.asarray(ref_stages.mean_aggregate_csr(
        jnp.asarray(table), jnp.asarray(seg), jnp.asarray(idx), n))
    got = stages.mean_aggregate_csr(torch.from_numpy(table),
                                    torch.from_numpy(seg),
                                    torch.from_numpy(idx), n)
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    assert torch.isfinite(got).all()


@pytest.mark.parametrize("kind", KINDS)
def test_plain_sums_in_edge_order(kind):
    """index_add_ on the CPU adds in index order: the plain sum is a left
    fold of each segment's edges in float32."""
    vals, seg, _, _, n = _case(kind)
    fold = np.zeros((n, vals.shape[1]), np.float32)
    for e in range(len(seg)):
        fold[seg[e]] = fold[seg[e]] + vals[e]
    got = tss.segment_sum_plain(torch.from_numpy(vals), torch.from_numpy(seg),
                                n)
    assert got.numpy().tobytes() == fold.tobytes()


@pytest.mark.parametrize("mean", [False, True])
@pytest.mark.parametrize("gather", [False, True])
@pytest.mark.parametrize("kind", KINDS)
def test_emulation_bitwise_equal_to_plain(kind, gather, mean):
    vals, seg, idx, table, n = _case(kind, seed=1)
    v = torch.from_numpy(table if gather else vals)
    i = torch.from_numpy(idx) if gather else None
    s = torch.from_numpy(seg)
    want = tss.segment_sum_plain(v, s, n, idx=i, mean=mean)
    assert torch.equal(tss.segment_sum_emulate(v, s, n, idx=i, mean=mean),
                       want)
    assert torch.equal(tss.segment_sum(v, s, n, idx=i, mean=mean), want)


@pytest.mark.parametrize("mean", [False, True])
@pytest.mark.parametrize("kind", KINDS)
def test_hot_indices_read_the_rows_they_name(kind, mean):
    """Residency: with ``hot``, ``idx`` addresses ``concat(table,
    table[hot])`` and a cache index reads the hot row it names, so the
    sum is bitwise the sum over the extended pool (the plain version, the
    emulation and the CPU wrapper alike), and bitwise the sum over the
    original indices, whose rows are the same."""
    _, seg, idx, table, n = _case(kind, seed=2)
    rng = np.random.default_rng(3)
    m = table.shape[0]
    hot = rng.choice(m, size=min(5, m), replace=False).astype(np.int32)
    slot = {int(v): i for i, v in enumerate(hot)}
    remapped = np.array([m + slot[int(v)] if int(v) in slot else v
                         for v in idx], np.int32)
    v, s = torch.from_numpy(table), torch.from_numpy(seg)
    h, r = torch.from_numpy(hot), torch.from_numpy(remapped)
    pool = torch.cat([v, v[h.long()]])
    want = tss.segment_sum_plain(pool, s, n, idx=r, mean=mean)
    assert torch.equal(want, tss.segment_sum_plain(
        v, s, n, idx=torch.from_numpy(idx), mean=mean))
    assert torch.equal(tss.segment_sum_plain(v, s, n, idx=r, mean=mean,
                                             hot=h), want)
    assert torch.equal(tss.segment_sum_emulate(v, s, n, idx=r, mean=mean,
                                               hot=h), want)
    assert torch.equal(ops.segment_sum(v, s, n, idx=r, mean=mean, hot=h),
                       want)
    assert tss.work(v, s, n, r, mean, hot=h)[0] == \
        tss.work(v, s, n, r, mean)[0] + 4 * len(hot)


@pytest.mark.parametrize("e", [0, 1, 31, 32, 33, 1023, 1024, 1025, 70000])
def test_kernel_search_finds_each_segment(e):
    """The kernel's 32-ary search (emulated) against np.searchsorted, with
    empty segments, long runs of one segment and a last segment past the
    list's end."""
    rng = np.random.default_rng(e)
    n = max(1, e // 20)
    seg = np.sort(rng.integers(0, n, e) ** 2 % n).astype(np.int32)
    starts, ends = tss.segment_bounds_emulate(seg, n + 2)
    ids = np.arange(n + 2)
    np.testing.assert_array_equal(starts, np.searchsorted(seg, ids, "left"))
    np.testing.assert_array_equal(ends, np.searchsorted(seg, ids, "right"))
    for lo, hi, s in [(0, e, 0), (0, e, n), (e // 3, e, n // 2)]:
        want = lo + np.searchsorted(seg[lo:hi], s, "left")
        assert tss.lower_bound_emulate(seg, lo, hi, s) == want


def test_wrapper_on_cpu_runs_the_plain_version_without_a_launch():
    vals, seg, idx, table, n = _case("heavy")
    ops.reset_launch_counts()
    out = ops.segment_sum(torch.from_numpy(table), torch.from_numpy(seg), n,
                          idx=torch.from_numpy(idx), mean=True)
    assert out.shape == (n, table.shape[1])
    assert ops.launch_counts()["segment_sum"] == 0


@pytest.mark.parametrize("bad", ["dtype", "idx_dtype", "contiguous", "rows",
                                 "empty"])
def test_kernel_arguments_are_checked(bad):
    vals, seg, idx, table, n = _case("heavy")
    v, s, i = (torch.from_numpy(vals), torch.from_numpy(seg),
               torch.from_numpy(idx))
    args = dict(vals=v, seg=s, n=n, idx=None)
    if bad == "dtype":
        args["vals"] = v.double()
    elif bad == "idx_dtype":
        args.update(vals=torch.from_numpy(table), idx=i.long())
    elif bad == "contiguous":
        args["vals"] = torch.from_numpy(np.ascontiguousarray(vals.T)).T
    elif bad == "rows":
        args["vals"] = v[:-1]
    else:
        args["n"] = 0
    with pytest.raises(ValueError, match="segment_sum"):
        tss.check_kernel_args(args["vals"], args["seg"], args["n"],
                              args["idx"])


def _gat_case(seed, n, m, h, dh, edges, empty_rows=()):
    rng = np.random.default_rng(seed)
    seg = np.sort(rng.integers(0, n, edges))
    seg = seg[~np.isin(seg, empty_rows)].astype(np.int32)
    idx = rng.integers(0, m, len(seg)).astype(np.int32)
    p = {"a_dst": rng.standard_normal((h, dh)).astype(np.float32) * 0.5,
         "a_src": rng.standard_normal((h, dh)).astype(np.float32) * 0.5}
    hd = rng.standard_normal((n, h, dh)).astype(np.float32)
    hs = rng.standard_normal((m, h, dh)).astype(np.float32)
    return p, hd, hs, seg, idx


@pytest.mark.parametrize("shape", [(30, 30, 4, 4, 200), (25, 60, 2, 8, 400),
                                   (9, 5, 8, 8, 60)])
def test_gat_aggregate_csr_matches_reference(shape):
    """SDDMM, segment max, segment softmax and SpMM against the reference's
    csr GAT; rows with no edge come out exactly 0, never NaN."""
    n = shape[0]
    p, hd, hs, seg, idx = _gat_case(0, *shape, empty_rows=(1, n - 1))
    want = np.asarray(ref_stages.gat_aggregate_csr(
        {k: jnp.asarray(v) for k, v in p.items()}, jnp.asarray(hd),
        jnp.asarray(hs), jnp.asarray(seg), jnp.asarray(idx), n))
    got = stages.gat_aggregate_csr(
        {k: torch.from_numpy(v) for k, v in p.items()}, torch.from_numpy(hd),
        torch.from_numpy(hs), torch.from_numpy(seg), torch.from_numpy(idx), n)
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    assert torch.isfinite(got).all()
    assert (got[1] == 0).all() and (got[n - 1] == 0).all()


def test_gat_aggregate_csr_without_edges_is_zero():
    p, hd, hs, _, _ = _gat_case(3, 6, 4, 2, 4, 1)
    none = torch.zeros(0, dtype=torch.int32)
    got = stages.gat_aggregate_csr(
        {k: torch.from_numpy(v) for k, v in p.items()}, torch.from_numpy(hd),
        torch.from_numpy(hs), none, none, 6)
    assert got.shape == (6, 2, 4) and (got == 0).all()


def test_gat_aggregate_bucketed_matches_reference():
    """Per bucket the padded GAT on the gathered rows, copied back to node
    order, against the reference's bucketed stage."""
    rng = np.random.default_rng(5)
    n, m, h, dh = 20, 20, 2, 4
    p = {"a_dst": rng.standard_normal((h, dh)).astype(np.float32),
         "a_src": rng.standard_normal((h, dh)).astype(np.float32)}
    hd = rng.standard_normal((n, h, dh)).astype(np.float32)
    rows = rng.permutation(n).astype(np.int32)
    buckets = []
    for lo, hi, k in [(0, 7, 2), (7, 15, 5), (15, 20, 9)]:
        r = rows[lo:hi]
        nbr = rng.integers(0, m, (len(r), k)).astype(np.int32)
        mask = (rng.random((len(r), k)) < 0.7).astype(np.float32)
        mask[0] = 0.0  # a row with no live slot
        buckets.append((r, nbr, mask))
    want = np.asarray(ref_stages.gat_aggregate_bucketed(
        {k: jnp.asarray(v) for k, v in p.items()}, jnp.asarray(hd),
        jnp.asarray(hd), [tuple(jnp.asarray(a) for a in b) for b in buckets]))
    tb = [tuple(torch.from_numpy(a) for a in b) for b in buckets]
    tp = {k: torch.from_numpy(v) for k, v in p.items()}
    got = stages.gat_aggregate_bucketed(tp, torch.from_numpy(hd),
                                        torch.from_numpy(hd), tb)
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    kern = stages.gat_aggregate_bucketed(
        tp, torch.from_numpy(hd), torch.from_numpy(hd), tb,
        agg_fn=lambda *a: ops.gat_aggregate(*a, use_pallas=True))
    np.testing.assert_allclose(kern.numpy(), want, **TOL)
