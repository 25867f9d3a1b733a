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


@pytest.mark.parametrize("mean", [True, False])
def test_emulation_matches_the_streaming_pallas_kernel(mean):
    x, w, nbr, mask = _case(2, 33, 80, 4, 70, 32, weighted=True)
    jx, jw, jn, jm = map(jnp.asarray, (x, w, nbr, mask))
    streaming = np.asarray(pallas_ffn(jx, jw, jn, jm, mean=mean, block_n=16,
                                      block_f=64, block_m=16,
                                      interpret=True))
    emu = tffn.fused_fp_na_emulate(*map(torch.from_numpy, (x, w, nbr, mask)),
                                   mean=mean)
    np.testing.assert_allclose(emu.numpy(), streaming, **TOL)


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
