"""Fused FP + NA of the port (``kernels/fused_fp_na.py``, ``kernels/ref.py``,
``kernels/ops.py``) against the reference: the JAX oracle and the Pallas
kernel run in interpret mode, resident and streaming, as
``tests/test_gat_na.py`` runs them.

Tolerance: atol = rtol = 1e-5 in fp32.  The Pallas kernel sums the
per-F-tile partial products, the emulation (like the CUDA kernel)
accumulates the product over the features in order, and the plain version
leaves the order to the matmul; that moves the last bits only.  The CUDA
kernel itself runs only on a card (``tests/test_torch_kernels_gpu.py``)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro.kernels.fused_fp_na import fused_fp_na as pallas_ffn
from repro_torch.kernels import fused_fp_na as tffn
from repro_torch.kernels import ops, ref

TOL = dict(atol=1e-5, rtol=1e-5)


def _case(seed, n, m, k, f, d, weighted=False):
    """Inputs from a numpy seed; rows 0 and n-1 have no live slot."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((m, f)).astype(np.float32)
    w = (rng.standard_normal((f, d)) / np.sqrt(f)).astype(np.float32)
    nbr = rng.integers(0, m, (n, k)).astype(np.int32)
    live = rng.random((n, k)) < 0.7
    mask = (rng.random((n, k)) * 2.0 if weighted else np.ones((n, k)))
    mask = (mask * live).astype(np.float32)
    mask[[0, n - 1]] = 0.0
    return x, w, nbr, mask


CASES = [  # (N, M, K, F, D): F never a multiple of BLOCK_F = 64
    (33, 80, 4, 70, 32),
    (50, 40, 9, 130, 64),  # three F-tiles, the last of 2 columns
    (17, 25, 1, 20, 24),  # K = 1, F below one tile, D not a multiple of 32
    # 18 F-tiles over SLICES = 8 slices of 3: six slices used, the last
    # tile partial (3 columns) and two slices empty
    (21, 30, 5, 1091, 16),
]


@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("mean", [True, False])
@pytest.mark.parametrize("case", CASES)
def test_plain_and_emulation_match_jax_ref_and_pallas(case, mean, weighted):
    x, w, nbr, mask = _case(1, *case, weighted=weighted)
    jx, jw, jn, jm = map(jnp.asarray, (x, w, nbr, mask))
    want = np.asarray(jref.fused_fp_na(jx, jw, jn, jm, mean=mean))
    pallas = np.asarray(pallas_ffn(jx, jw, jn, jm, mean=mean, block_n=16,
                                   interpret=True))
    np.testing.assert_allclose(pallas, want, **TOL)
    tx, tw, tn, tm = map(torch.from_numpy, (x, w, nbr, mask))
    plain = ref.fused_fp_na(tx, tw, tn, tm, mean=mean).numpy()
    emu = tffn.fused_fp_na_emulate(tx, tw, tn, tm, mean=mean).numpy()
    np.testing.assert_allclose(plain, want, **TOL)
    np.testing.assert_allclose(emu, pallas, **TOL)
    for out in (plain, emu):
        assert (out[[0, -1]] == 0).all()  # exactly 0, not NaN


@pytest.mark.parametrize("case", [(33, 80, 4, 70, 32), (21, 30, 5, 1091, 16)])
@pytest.mark.parametrize("mean", [True, False])
def test_emulation_matches_the_streaming_pallas_kernel(mean, case):
    x, w, nbr, mask = _case(2, *case, weighted=True)
    jx, jw, jn, jm = map(jnp.asarray, (x, w, nbr, mask))
    streaming = np.asarray(pallas_ffn(jx, jw, jn, jm, mean=mean, block_n=16,
                                      block_f=64, block_m=16,
                                      interpret=True))
    emu = tffn.fused_fp_na_emulate(*map(torch.from_numpy, (x, w, nbr, mask)),
                                   mean=mean)
    np.testing.assert_allclose(emu.numpy(), streaming, **TOL)


def test_emulation_sums_the_slices_in_order():
    """The kernel's F-slice split: each slice's partial over its own
    F-tiles, then the partials added in slice order, partial 0 first: the
    sum of the plain function on each slice's rows of W, and the plain
    function on the whole of W."""
    n, m, k, f, d = 12, 20, 6, 9 * tffn.BLOCK_F + 7, 8  # 10 tiles, 5 slices
    x, w, nbr, mask = map(torch.from_numpy, _case(6, n, m, k, f, d))
    n_tiles = -(-f // tffn.BLOCK_F)
    per = -(-n_tiles // tffn.SLICES)
    assert (n_tiles, per) == (10, 2)
    out = tffn.fused_fp_na_emulate(x, w, nbr, mask)
    parts = []
    for s in range(tffn.SLICES):
        lo = min(f, s * per * tffn.BLOCK_F)
        hi = min(f, (s + 1) * per * tffn.BLOCK_F)
        wz = torch.zeros_like(w)
        wz[lo:hi] = w[lo:hi]
        parts.append(ref.fused_fp_na(x, wz, nbr, mask))
    np.testing.assert_allclose(out.numpy(), sum(parts).numpy(), **TOL)
    np.testing.assert_allclose(out.numpy(),
                               ref.fused_fp_na(x, w, nbr, mask).numpy(),
                               **TOL)
    assert (out[[0, -1]] == 0).all()


def test_fused_equals_segment_spmm_then_projection():
    """The executor's own order (FP, then NA) is the same function: by
    linearity ``mean_k(x[nbr]) @ W == mean_k((x @ W)[nbr])``."""
    x, w, nbr, mask = map(torch.from_numpy, _case(3, 40, 30, 6, 90, 16))
    np.testing.assert_allclose(
        tffn.fused_fp_na_emulate(x, w, nbr, mask).numpy(),
        ref.segment_spmm(x @ w, nbr, mask).numpy(), **TOL)


def test_wrapper_takes_the_plain_version_on_cpu():
    x, w, nbr, mask = map(torch.from_numpy, _case(4, 20, 15, 3, 40, 8))
    before = tffn.fused_fp_na.launches
    got = ops.fused_fp_na(x, w, nbr, mask, mean=True, use_pallas=True)
    assert tffn.fused_fp_na.launches == before
    assert torch.equal(got, ref.fused_fp_na(x, w, nbr, mask, mean=True))
    assert torch.equal(ops.fused_fp_na(x, w, nbr, mask, mean=False),
                       ref.fused_fp_na(x, w, nbr, mask, mean=False))


def test_kernel_args_are_checked():
    x, w, nbr, mask = map(torch.from_numpy, _case(5, 10, 8, 3, 12, 4))
    tffn.check_kernel_args(x, w, nbr, mask)
    with pytest.raises(ValueError, match="int32"):
        tffn.check_kernel_args(x, w, nbr.long(), mask)
    with pytest.raises(ValueError, match="float32"):
        tffn.check_kernel_args(x, w.double(), nbr, mask)
    with pytest.raises(ValueError, match="F, D"):
        tffn.check_kernel_args(x, w[:5], nbr, mask)
    with pytest.raises(ValueError, match="contiguous"):
        tffn.check_kernel_args(x.t().contiguous().t(), w, nbr, mask)
    with pytest.raises(ValueError, match="no kernel for device meta"):
        tffn.fused_fp_na(*(t.to("meta") for t in (x, w, nbr, mask)))


def test_launch_scratch_is_kept_per_stream_and_zero_when_made():
    """The kernels' counters and partials live in ``build.scratch``: one
    buffer a (use, device, stream), zero when it is allocated (the kernels
    leave their counters at 0), reused while it is large enough and
    replaced by a larger zeroed one when it is not."""
    from repro_torch.kernels import build

    a = build.scratch("test counters", 5, torch.int32, "cpu", 11)
    assert a.dtype == torch.int32 and a.numel() == 5
    assert torch.equal(a, torch.zeros(5, dtype=torch.int32))
    a.fill_(7)
    assert build.scratch("test counters", 3, torch.int32, "cpu", 11) is a
    assert build.scratch("test counters", 5, torch.int32, "cpu", 12) is not a
    b = build.scratch("test counters", 9, torch.int32, "cpu", 11)
    assert b is not a and b.numel() == 9 and not b.any()
    assert build.scratch("test counters", 9, torch.int32, "cpu", 11) is b
