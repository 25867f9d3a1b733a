"""Fused GAT-NA of the port (``kernels/gat_na.py``, ``kernels/ref.py``,
``core/stages.py``) against the reference: the JAX oracles and the Pallas
kernel run in interpret mode, as ``tests/test_gat_na.py`` runs it.

Tolerance: atol = rtol = 1e-5 in fp32.  Both sides compute the same
softmax; the Pallas kernel reduces in tile order and the torch version
over the whole row, which moves the last bits only.  The CUDA kernel
itself runs only on a card (``tests/test_torch_kernels_gpu.py``)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import stages as ref_stages
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
    assert ops.launch_counts() == {"gat_na": 0, "gat_na_fused_sa": 0,
                                   "semantic_combine": 0, "segment_spmm": 0,
                                   "fused_fp_na": 0}


def test_wrapper_takes_only_the_stacked_form():
    c = _case(3, 1, 40, 30, 6, 4, 4)
    p, hd, hs, nbr, mask, sem = _torch(c)
    p1 = {k: v[0] for k, v in p.items()}
    for kw in ({}, {"sem": sem}):
        with pytest.raises(ValueError, match="stacked form"):
            tgat.gat_na(p1, hd, hs, nbr[0], mask[0], **kw)


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
