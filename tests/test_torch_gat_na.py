"""Fused GAT-NA of the port (``kernels/gat_na.py``, ``kernels/ref.py``,
``core/stages.py``) against the reference: the JAX oracles and the Pallas
kernel run in interpret mode, as ``tests/test_gat_na.py`` runs it.

Both call forms are covered: the stacked ``[S, N, K]`` one (HAN) and the
unstacked ``[N, K]`` one (MAGNN's instance attention over an ``arange``
grid), which the wrapper lifts to S = 1.

Tolerance: atol = rtol = 1e-5 in fp32.  Both sides compute the same
softmax; the Pallas kernel reduces in tile order and the torch version
over the whole row, which moves the last bits only.  The CUDA kernel
itself runs only on a card (``tests/test_torch_kernels_gpu.py``)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import stages as ref_stages
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.kernels.gat_na import gat_na as pallas_gat_na
from repro_torch.core import stages
from repro_torch.kernels import gat_na as tgat
from repro_torch.kernels import ops, ref

TOL = dict(atol=1e-5, rtol=1e-5)


def _case(seed, s_dim, n, m, k, h, dh, hs=16):
    """Stacked inputs from a numpy seed; rows 0, 7 and n-1 of every
    metapath (and row 3 of metapath 0) have no live neighbour."""
    rng = np.random.default_rng(seed)
    f32 = np.float32
    c = {
        "h_dst": rng.standard_normal((n, h, dh)).astype(f32),
        "h_src": rng.standard_normal((m, h, dh)).astype(f32),
        "nbr": rng.integers(0, m, (s_dim, n, k)).astype(np.int32),
        "mask": (rng.random((s_dim, n, k)) < 0.7).astype(f32),
        "a_dst": (rng.standard_normal((s_dim, h, dh)) * 0.3).astype(f32),
        "a_src": (rng.standard_normal((s_dim, h, dh)) * 0.3).astype(f32),
        "W": (rng.standard_normal((h * dh, hs)) / np.sqrt(h * dh)).astype(f32),
        "b": (rng.standard_normal(hs) * 0.1).astype(f32),
        "q": (rng.standard_normal(hs) / np.sqrt(hs)).astype(f32),
    }
    c["mask"][:, [0, 7, n - 1]] = 0.0
    c["mask"][0, 3] = 0.0
    return c


def _torch(c):
    t = {k: torch.from_numpy(v.copy()) for k, v in c.items()}
    p = {"a_dst": t["a_dst"], "a_src": t["a_src"]}
    sem = {"W": t["W"], "b": t["b"], "q": t["q"]}
    return p, t["h_dst"], t["h_src"], t["nbr"], t["mask"], sem


def _jax(c):
    j = {k: jnp.asarray(v) for k, v in c.items()}
    p = {"a_dst": j["a_dst"], "a_src": j["a_src"]}
    sem = {"W": j["W"], "b": j["b"], "q": j["q"]}
    return p, j["h_dst"], j["h_src"], j["nbr"], j["mask"], sem


SHAPES = [  # (S, N, M, K, H, Dh): N never a multiple of 128
    (2, 150, 130, 9, 4, 8),
    (2, 45, 60, 33, 8, 8),
    (1, 70, 70, 5, 2, 16),
]


@pytest.mark.parametrize("shape", SHAPES)
def test_plain_gat_na_matches_jax_ref_and_pallas(shape):
    c = _case(1, *shape)
    p, hd, hs, nbr, mask, _ = _torch(c)
    got = ref.gat_na(p, hd, hs, nbr, mask).numpy()
    jp, jhd, jhs, jnbr, jmask, _ = _jax(c)
    np.testing.assert_allclose(got, np.asarray(
        jref.gat_na(jp, jhd, jhs, jnbr, jmask)), **TOL)
    np.testing.assert_allclose(got, np.asarray(pallas_gat_na(
        jp, jhd, jhs, jnbr, jmask, interpret=True)), **TOL)
    assert got[:, [0, 7]].max() == 0.0 and got[:, [0, 7]].min() == 0.0


@pytest.mark.parametrize("shape", SHAPES)
def test_plain_gat_na_fused_sa_matches_jax_ref_and_pallas(shape):
    c = _case(2, *shape)
    p, hd, hs, nbr, mask, sem = _torch(c)
    z, w = ref.gat_na_fused_sa(p, hd, hs, nbr, mask, sem["W"], sem["b"],
                               sem["q"])
    jp, jhd, jhs, jnbr, jmask, jsem = _jax(c)
    for jz, jw in (
            jref.gat_na_fused_sa(jp, jhd, jhs, jnbr, jmask, jsem["W"],
                                 jsem["b"], jsem["q"]),
            pallas_gat_na(jp, jhd, jhs, jnbr, jmask, interpret=True,
                          sem=jsem)):
        np.testing.assert_allclose(z.numpy(), np.asarray(jz), **TOL)
        np.testing.assert_allclose(w.numpy(), np.asarray(jw), **TOL)
    assert np.all(z.numpy()[:, [0, 7]] == 0.0)  # elu(0) of all-masked rows


@pytest.mark.parametrize("shape", SHAPES)
def test_kernel_emulation_matches_pallas(shape):
    """The CUDA kernel's algorithm, replayed in PyTorch (slot-order online
    softmax, block-ordered score sum), against the Pallas kernel."""
    c = _case(7, *shape)
    p, hd, hs, nbr, mask, sem = _torch(c)
    jp, jhd, jhs, jnbr, jmask, jsem = _jax(c)
    got = tgat.gat_na_emulate(p, hd, hs, nbr, mask)
    np.testing.assert_allclose(got.numpy(), np.asarray(pallas_gat_na(
        jp, jhd, jhs, jnbr, jmask, interpret=True)), **TOL)
    assert np.all(got.numpy()[:, [0, 7]] == 0.0)
    z, w = tgat.gat_na_emulate(p, hd, hs, nbr, mask, sem=sem)
    jz, jw = pallas_gat_na(jp, jhd, jhs, jnbr, jmask, interpret=True,
                           sem=jsem)
    np.testing.assert_allclose(z.numpy(), np.asarray(jz), **TOL)
    np.testing.assert_allclose(w.numpy(), np.asarray(jw), **TOL)


# live counts a row (K = 64) against the kernel's gather batch (8 live
# slots at H*Dh <= 64, 4 at <= 128): none, one, a batch exactly, one past
# it, a ragged count across the first 32-slot ballot, and all 64
LIVE_COUNTS = [0, 1, 8, 9, 13, 31, 33, 47, 64]


def _live_count_case(seed, s_dim, n, m, h, dh, hs):
    """K = 64 with each row's live count taken from ``LIVE_COUNTS`` in
    turn, the live slots scattered over the row."""
    c = _case(seed, s_dim, n, m, 64, h, dh, hs)
    rng = np.random.default_rng(seed + 100)
    mask = np.zeros((s_dim, n, 64), np.float32)
    for s in range(s_dim):
        for r in range(n):
            live = LIVE_COUNTS[(r + s) % len(LIVE_COUNTS)]
            mask[s, r, rng.permutation(64)[:live]] = 1.0
    c["mask"] = mask
    return c


@pytest.mark.parametrize("h,dh,hs", [(8, 8, 128), (4, 8, 300), (16, 8, 20)])
def test_kernel_emulation_matches_pallas_across_batches(h, dh, hs):
    """Live counts that are not a multiple of the gather batch, all 64
    slots live and all masked; Hs over one, two and three of the
    epilogue's 128-column groups."""
    c = _live_count_case(8, 2, 37, 50, h, dh, hs)
    p, hd, hsrc, nbr, mask, sem = _torch(c)
    jp, jhd, jhs, jnbr, jmask, jsem = _jax(c)
    dead = (c["mask"].sum(-1) == 0)
    assert dead.any() and (c["mask"].sum(-1) == 64).any()
    got = tgat.gat_na_emulate(p, hd, hsrc, nbr, mask)
    np.testing.assert_allclose(got.numpy(), np.asarray(pallas_gat_na(
        jp, jhd, jhs, jnbr, jmask, interpret=True)), **TOL)
    assert np.all(got.numpy()[dead] == 0.0)
    z, w = tgat.gat_na_emulate(p, hd, hsrc, nbr, mask, sem=sem)
    jz, jw = pallas_gat_na(jp, jhd, jhs, jnbr, jmask, interpret=True,
                           sem=jsem)
    np.testing.assert_allclose(z.numpy(), np.asarray(jz), **TOL)
    np.testing.assert_allclose(w.numpy(), np.asarray(jw), **TOL)
    zp, wp = tgat.gat_na_plain(p, hd, hsrc, nbr, mask, sem)
    np.testing.assert_allclose(w.numpy(), wp.numpy(), **TOL)


def test_emulation_score_order_is_the_kernels():
    """The epilogue's reduction order, written out: a row's score sums
    ``q·tanh(zW + b)`` over lane l's columns ``128 j + 4 l + c`` in order,
    then the 32 lanes by an xor butterfly; the rows in blocks of 16 in
    order; block b to lane b % 32 in order; the lanes by a butterfly."""
    x = torch.arange(32, dtype=torch.float32)
    assert float(tgat._butterfly(x)) == float(x.sum())
    lanes = torch.tensor([1e8] + [1.0] * 31)  # order shows in the bits
    want = lanes.clone()
    for step in (16, 8, 4, 2, 1):  # lane 0 of an xor-shuffle sum
        want = torch.stack([want[i] + want[i ^ step] for i in range(32)])
    assert float(tgat._butterfly(lanes)) == float(want[0])
    c = _case(9, 1, 40, 40, 6, 4, 8, hs=260)
    p, hd, hsrc, nbr, mask, sem = _torch(c)
    z, w = tgat.gat_na_emulate(p, hd, hsrc, nbr, mask, sem=sem)
    val = sem["q"] * torch.tanh(z.reshape(1, 40, -1) @ sem["W"] + sem["b"])
    val = torch.nn.functional.pad(val, (0, 384 - 260))
    score = []
    for r in range(40):
        per_lane = []
        for lane in range(32):
            t = torch.tensor(0.0)
            for j in range(3):
                for cc in range(4):
                    t = t + val[0, r, 128 * j + 4 * lane + cc]
            per_lane.append(t)
        score.append(tgat._butterfly(torch.stack(per_lane)))
    blocks = [sum(score[i:i + 16], torch.tensor(0.0))
              for i in range(0, 40, 16)]
    lanes = torch.zeros(32)
    lanes[:3] = torch.stack(blocks)
    assert torch.equal(w, tgat._butterfly(lanes)[None] / 40)


@pytest.mark.parametrize("shape", SHAPES)
def test_wrapper_on_cpu_runs_plain_and_counts_nothing(shape):
    c = _case(4, *shape)
    p, hd, hs, nbr, mask, sem = _torch(c)
    ops.reset_launch_counts()
    got = ops.gat_aggregate_stacked(p, hd, hs, nbr, mask, use_pallas=True)
    z, w = ops.gat_aggregate_stacked_fused_sa(p, hd, hs, nbr, mask, sem,
                                              use_pallas=True)
    assert torch.equal(got, tgat.gat_na_plain(p, hd, hs, nbr, mask))
    zp, wp = tgat.gat_na_plain(p, hd, hs, nbr, mask, sem)
    assert torch.equal(z, zp) and torch.equal(w, wp)
    counts = ops.launch_counts()
    assert counts["gat_na"] == counts["gat_na_fused_sa"] == 0
    assert set(counts.values()) == {0}


def test_wrapper_takes_only_the_stacked_form():
    """The stacked form is the only form the kernel runs: the unstacked
    ``[N, K]`` form is lifted to it (S = 1) and comes back unlifted, with
    the same bits; a table of any other rank is refused."""
    c = _case(3, 1, 40, 30, 6, 4, 4)
    p, hd, hs, nbr, mask, sem = _torch(c)
    p1 = {k: v[0] for k, v in p.items()}
    assert torch.equal(tgat.gat_na(p1, hd, hs, nbr[0], mask[0]),
                       tgat.gat_na(p, hd, hs, nbr, mask)[0])
    z1, w1 = tgat.gat_na(p1, hd, hs, nbr[0], mask[0], sem=sem)
    z, w = tgat.gat_na(p, hd, hs, nbr, mask, sem=sem)
    assert torch.equal(z1, z[0]) and torch.equal(w1, w[0])
    assert w1.shape == ()
    for kw in ({}, {"sem": sem}):
        with pytest.raises(ValueError, match="\\[S, N, K\\] or \\[N, K\\]"):
            tgat.gat_na(p1, hd, hs, nbr[0, 0], mask[0, 0], **kw)


def test_wrapper_rejects_mixed_and_unknown_devices():
    c = _case(5, 1, 20, 20, 4, 2, 4)
    p, hd, hs, nbr, mask, _ = _torch(c)
    with pytest.raises(ValueError, match="several devices"):
        tgat.gat_na(p, hd.to("meta"), hs, nbr, mask)
    meta = {k: v.to("meta") for k, v in p.items()}
    with pytest.raises(ValueError, match="no kernel"):
        tgat.gat_na(meta, hd.to("meta"), hs.to("meta"), nbr.to("meta"),
                    mask.to("meta"))


def _main_shape_args(**over):
    """Meta tensors at the HAN/imdb main-path shapes."""
    s, n, k, h, dh, hsd = 2, 4278, 64, 8, 8, 128
    a = dict(
        p={"a_dst": torch.empty((s, h, dh), device="meta"),
           "a_src": torch.empty((s, h, dh), device="meta")},
        h_dst=torch.empty((n, h, dh), device="meta"),
        h_src=torch.empty((n, h, dh), device="meta"),
        nbr=torch.empty((s, n, k), dtype=torch.int32, device="meta"),
        mask=torch.empty((s, n, k), device="meta"),
        sem={"W": torch.empty((h * dh, hsd), device="meta"),
             "b": torch.empty((hsd,), device="meta"),
             "q": torch.empty((hsd,), device="meta")})
    a.update(over)
    return a


def test_kernel_args_accept_the_main_path_shapes():
    tgat.check_kernel_args(**_main_shape_args())
    tgat.check_kernel_args(**_main_shape_args(sem=None))


@pytest.mark.parametrize("over,match", [
    (dict(h_dst=torch.empty((4278, 3, 3), device="meta"),
          h_src=torch.empty((4278, 3, 3), device="meta")), "h_dst|a_dst|32"),
    (dict(nbr=torch.empty((2, 4278, 64), dtype=torch.int64, device="meta")),
     "int32"),
    (dict(mask=torch.empty((2, 4278, 63), device="meta")), "one shape"),
    (dict(h_dst=torch.empty((64, 4278), device="meta").t().reshape(
        4278, 8, 8)), "contiguous"),
    (dict(sem={"W": torch.empty((64, 128), device="meta"),
               "b": torch.empty((127,), device="meta"),
               "q": torch.empty((128,), device="meta")}), "sem needs"),
    (dict(sem={"W": torch.empty((64, 4096), device="meta"),
               "b": torch.empty((4096,), device="meta"),
               "q": torch.empty((4096,), device="meta")}), "shared memory"),
])
def test_kernel_args_reject_what_the_kernel_does_not_take(over, match):
    with pytest.raises(ValueError, match=match):
        tgat.check_kernel_args(**_main_shape_args(**over))


def test_kernel_args_reject_wide_rows_and_odd_head_dims():
    wide = _main_shape_args()
    wide.update(
        p={k: torch.empty((2, 16, 32), device="meta") for k in wide["p"]},
        h_dst=torch.empty((4278, 16, 32), device="meta"),
        h_src=torch.empty((4278, 16, 32), device="meta"), sem=None)
    with pytest.raises(ValueError, match="H\\*Dh <= 256"):
        tgat.check_kernel_args(**wide)
    odd = dict(wide, p={k: torch.empty((2, 4, 12), device="meta")
                        for k in wide["p"]},
               h_dst=torch.empty((4278, 4, 12), device="meta"),
               h_src=torch.empty((4278, 4, 12), device="meta"))
    with pytest.raises(ValueError, match="divides 32"):
        tgat.check_kernel_args(**odd)


@pytest.mark.parametrize("shape", SHAPES[:2])
def test_stages_gat_aggregate_matches_jax_stages(shape):
    c = _case(6, *shape)
    p, hd, hs, nbr, mask, _ = _torch(c)
    jp, jhd, jhs, jnbr, jmask, _ = _jax(c)
    # the stacked form gathers from the destination table: rows < N
    nbr_self = nbr % shape[1]
    jnbr_self = jnp.asarray(c["nbr"] % shape[1])
    p0 = {k: v[0] for k, v in p.items()}
    jp0 = {k: v[0] for k, v in jp.items()}
    np.testing.assert_allclose(
        stages.gat_aggregate_padded(p0, hd, hs, nbr[0], mask[0]).numpy(),
        np.asarray(ref_stages.gat_aggregate_padded(jp0, jhd, jhs, jnbr[0],
                                                   jmask[0])), **TOL)
    np.testing.assert_allclose(
        stages.gat_aggregate_padded_stacked(p, hd, nbr_self, mask).numpy(),
        np.asarray(ref_stages.gat_aggregate_padded_stacked(
            jp, jhd, jnbr_self, jmask)), **TOL)


# ---------------------------------------------------------------------------
# the unstacked call form (MAGNN's instance attention)
# ---------------------------------------------------------------------------


def _unstacked(c):
    """Metapath 0 of a stacked case, in the ``[N, K]`` / ``[H, Dh]`` form."""
    p, hd, hs, nbr, mask, sem = _torch(c)
    jp, jhd, jhs, jnbr, jmask, jsem = _jax(c)
    return ({k: v[0] for k, v in p.items()}, hd, hs, nbr[0], mask[0], sem,
            {k: v[0] for k, v in jp.items()}, jhd, jhs, jnbr[0], jmask[0],
            jsem)


def _arange_case(seed, n, i, h, dh):
    """MAGNN's kernel-arm inputs: the encoded instances ``[n*i, H, Dh]`` as
    the source pool, an ``arange`` neighbour grid, and rows 0, 5 and n-1
    with no live instance."""
    rng = np.random.default_rng(seed)
    f32 = np.float32
    c = {"h_dst": rng.standard_normal((n, h, dh)).astype(f32),
         "h_src": rng.standard_normal((n * i, h, dh)).astype(f32),
         "nbr": np.arange(n * i, dtype=np.int32).reshape(1, n, i),
         "mask": (rng.random((1, n, i)) < 0.5).astype(f32),
         "a_dst": (rng.standard_normal((1, h, dh)) * 0.3).astype(f32),
         "a_src": (rng.standard_normal((1, h, dh)) * 0.3).astype(f32),
         "W": np.zeros((h * dh, 4), f32), "b": np.zeros(4, f32),
         "q": np.zeros(4, f32)}
    c["mask"][0, [0, 5, n - 1]] = 0.0
    return c


UNSTACKED = [("random", (9, 1, 150, 130, 9, 4, 8)),
             ("random", (10, 1, 45, 60, 33, 8, 8)),
             ("arange", (11, 70, 16, 8, 8)),
             ("arange", (12, 33, 4, 4, 4))]


def _unstacked_case(kind, args):
    c = _case(*args) if kind == "random" else _arange_case(*args)
    return c, _unstacked(c)


@pytest.mark.parametrize("kind,args", UNSTACKED)
def test_unstacked_form_matches_jax_ref_and_pallas(kind, args):
    c, (p, hd, hs, nbr, mask, _, jp, jhd, jhs, jnbr, jmask, _) = \
        _unstacked_case(kind, args)
    want = np.asarray(jref.gat_na(jp, jhd, jhs, jnbr, jmask))
    pallas = np.asarray(pallas_gat_na(jp, jhd, jhs, jnbr, jmask,
                                      interpret=True))
    assert want.shape == (hd.shape[0],) + tuple(hd.shape[1:])
    dead = np.where(c["mask"][0].sum(-1) == 0)[0]
    assert len(dead) >= 2
    for got in (ref.gat_na(p, hd, hs, nbr, mask),
                tgat.gat_na(p, hd, hs, nbr, mask),
                tgat.gat_na_emulate(p, hd, hs, nbr, mask),
                ops.gat_aggregate(p, hd, hs, nbr, mask, use_pallas=True),
                ops.gat_aggregate(p, hd, hs, nbr, mask, use_pallas=False)):
        assert got.shape == want.shape
        np.testing.assert_allclose(got.numpy(), want, **TOL)
        np.testing.assert_allclose(got.numpy(), pallas, **TOL)
        assert np.all(got.numpy()[dead] == 0.0)  # exactly 0, never NaN


@pytest.mark.parametrize("kind,args", UNSTACKED[:3])
def test_unstacked_fused_form_matches_jax_ref_and_pallas(kind, args):
    c, (p, hd, hs, nbr, mask, sem, jp, jhd, jhs, jnbr, jmask, jsem) = \
        _unstacked_case(kind, args)
    if kind == "arange":
        sem = {k: torch.full_like(v, 0.1) for k, v in sem.items()}
        jsem = {k: jnp.asarray(v.numpy()) for k, v in sem.items()}
    jz, jw = pallas_gat_na(jp, jhd, jhs, jnbr, jmask, interpret=True,
                           sem=jsem)
    for z, w in (tgat.gat_na(p, hd, hs, nbr, mask, sem=sem),
                 tgat.gat_na_emulate(p, hd, hs, nbr, mask, sem=sem)):
        assert w.shape == ()
        np.testing.assert_allclose(z.numpy(), np.asarray(jz), **TOL)
        np.testing.assert_allclose(w.numpy(), np.asarray(jw), **TOL)


def test_ops_gat_aggregate_matches_the_jax_ops_wrapper():
    _, (p, hd, hs, nbr, mask, _, jp, jhd, jhs, jnbr, jmask, _) = \
        _unstacked_case(*UNSTACKED[2])
    ops.reset_launch_counts()
    for use_pallas in (False, True):
        want = np.asarray(jops.gat_aggregate(jp, jhd, jhs, jnbr, jmask,
                                             use_pallas=use_pallas))
        got = ops.gat_aggregate(p, hd, hs, nbr, mask, use_pallas=use_pallas)
        np.testing.assert_allclose(got.numpy(), want, **TOL)
    assert ops.launch_counts()["gat_na"] == 0  # CPU: the plain version


def test_kernel_args_accept_the_magnn_shapes():
    """MAGNN/imdb's MAM launch: 4278 targets, 16 instances each, the
    encoded instances [68448, 8, 8] as the source pool."""
    n, i, h, dh = 4278, 16, 8, 8
    tgat.check_kernel_args(
        {"a_dst": torch.empty((h, dh), device="meta"),
         "a_src": torch.empty((h, dh), device="meta")},
        torch.empty((n, h, dh), device="meta"),
        torch.empty((n * i, h, dh), device="meta"),
        torch.empty((n, i), dtype=torch.int32, device="meta"),
        torch.empty((n, i), device="meta"))
    with pytest.raises(ValueError, match="a_dst"):
        tgat.check_kernel_args(
            {"a_dst": torch.empty((2, h, dh), device="meta"),
             "a_src": torch.empty((2, h, dh), device="meta")},
            torch.empty((n, h, dh), device="meta"),
            torch.empty((n * i, h, dh), device="meta"),
            torch.empty((n, i), dtype=torch.int32, device="meta"),
            torch.empty((n, i), device="meta"))
