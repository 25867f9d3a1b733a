"""The port's CUDA kernels on the card, held against their plain PyTorch
versions at edge shapes (partial warps, K across slot chunks, all-masked
rows, every head width the kernel takes).  Every test needs a CUDA device
and skips without one.  The file imports no jax, so it also runs where only
PyTorch is installed:

    PYTHONPATH=src python -m pytest --noconftest -p no:cacheprovider \\
        -m gpu tests/test_torch_kernels_gpu.py

Tolerances: the kernel's online softmax rescales per slot where the plain
version normalises once, so z agrees to atol = rtol = 1e-5; w sums the
row scores in another order (atol = rtol = 1e-5 at these row counts).  The
combine kernel rounds as its plain version does, so it is held bitwise.
``segment_spmm`` adds the live slots in slot order where the plain version
sums the ``[N, K, D]`` product in another order (atol = rtol = 1e-5), and
it is held bitwise against its emulation, which rounds step by step as the
kernel does.  ``fused_fp_na`` accumulates the product over F in order with
FMA where the plain version leaves the order to the matmul, so its error
grows with F and with the size of the terms: rtol = 1e-5 and an atol of
1e-5 times the largest |output| (at F = 3066 with unit-normal features and
no mean, 2.9e-5 of outputs up to about 30 on the H100).
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import build
from repro_torch.kernels import fused_fp_na as tffn
from repro_torch.kernels import gat_na as tgat
from repro_torch.kernels import ops
from repro_torch.kernels import segment_spmm as tspmm
from repro_torch.kernels import semantic_attn as tsem

pytestmark = pytest.mark.gpu
TOL = dict(atol=1e-5, rtol=1e-5)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _case(seed, s_dim, n, m, k, h, dh, hs, device):
    rng = np.random.default_rng(seed)

    def t(a, dtype=torch.float32):
        return torch.as_tensor(a, dtype=dtype, device=device)

    mask = (rng.random((s_dim, n, k)) < 0.6).astype(np.float32)
    mask[:, :: 7] = 0.0  # all-masked rows
    p = {"a_dst": t(rng.standard_normal((s_dim, h, dh)) * 0.3),
         "a_src": t(rng.standard_normal((s_dim, h, dh)) * 0.3)}
    sem = {"W": t(rng.standard_normal((h * dh, hs)) / np.sqrt(h * dh)),
           "b": t(rng.standard_normal(hs) * 0.1),
           "q": t(rng.standard_normal(hs) / np.sqrt(hs))}
    return (p, t(rng.standard_normal((n, h, dh))),
            t(rng.standard_normal((m, h, dh))),
            t(rng.integers(0, m, (s_dim, n, k)), torch.int32), t(mask), sem)


SHAPES = [  # (S, N, M, K, H, Dh, Hs)
    (2, 37, 50, 9, 4, 8, 16),  # rows not a multiple of a block
    (1, 100, 80, 70, 8, 8, 128),  # K spans three slot chunks
    (3, 17, 20, 5, 1, 32, 33),  # one head of 32; Hs not a multiple of 32
    (2, 50, 40, 12, 16, 16, 64),  # H*Dh = 256, the widest row
    (1, 33, 10, 3, 4, 4, 8),  # H*Dh = 16: half the lanes idle
    (2, 25, 30, 40, 2, 1, 7),  # Dh = 1
]


def test_kernel_constants_agree_with_the_wrapper(cuda):
    lib = build.library()
    assert lib.gat_na_rows_per_block() == tgat.ROWS_PER_BLOCK
    assert lib.gat_na_max_features() == tgat.MAX_FEATURES


@pytest.mark.parametrize("shape", SHAPES)
def test_gat_na_kernel_matches_plain(cuda, shape):
    p, hd, hs, nbr, mask, _ = _case(1, *shape, cuda)
    before = tgat.gat_na.launches
    got = tgat.gat_na(p, hd, hs, nbr, mask)
    torch.cuda.synchronize()
    assert tgat.gat_na.launches == before + 1
    want = tgat.gat_na_plain(p, hd, hs, nbr, mask)
    torch.testing.assert_close(got, want, **TOL)
    assert torch.all(got[:, ::7] == 0)


@pytest.mark.parametrize("shape", SHAPES)
def test_gat_na_fused_kernel_matches_plain(cuda, shape):
    p, hd, hs, nbr, mask, sem = _case(2, *shape, cuda)
    before = tgat.gat_na.fused_launches
    z, w = tgat.gat_na(p, hd, hs, nbr, mask, sem=sem)
    torch.cuda.synchronize()
    assert tgat.gat_na.fused_launches == before + 1
    zp, wp = tgat.gat_na_plain(p, hd, hs, nbr, mask, sem)
    torch.testing.assert_close(z, zp, **TOL)
    torch.testing.assert_close(w, wp, **TOL)
    assert torch.all(z[:, ::7] == 0)
    z2, w2 = tgat.gat_na(p, hd, hs, nbr, mask, sem=sem)
    assert torch.equal(z, z2) and torch.equal(w, w2)  # no float atomics


@pytest.mark.parametrize("shape", SHAPES[:3])
def test_gat_na_kernel_matches_its_emulation(cuda, shape):
    """Same algorithm, same slot order: the kernel against its PyTorch
    replay (``gat_na_emulate``), which the CPU tests hold against Pallas."""
    p, hd, hs, nbr, mask, sem = _case(5, *shape, cuda)
    torch.testing.assert_close(tgat.gat_na(p, hd, hs, nbr, mask),
                               tgat.gat_na_emulate(p, hd, hs, nbr, mask),
                               **TOL)
    z, w = tgat.gat_na(p, hd, hs, nbr, mask, sem=sem)
    ze, we = tgat.gat_na_emulate(p, hd, hs, nbr, mask, sem=sem)
    torch.testing.assert_close(z, ze, **TOL)
    torch.testing.assert_close(w, we, **TOL)


def test_gat_na_kernel_raises_instead_of_falling_back(cuda):
    p, hd, hs, nbr, mask, _ = _case(4, *SHAPES[0], cuda)
    before = tgat.gat_na.launches
    with pytest.raises(ValueError, match="int32"):
        ops.gat_aggregate_stacked(p, hd, hs, nbr.long(), mask,
                                  use_pallas=True)
    assert tgat.gat_na.launches == before


@pytest.mark.parametrize("p,n,d,offset", [
    (2, 4278, 64, 0),  # the main path
    (3, 101, 3, 0),  # N*D not a multiple of a block or of 4
    (2, 64, 8, 1),  # storage 4 bytes off a 16-byte boundary
])
def test_semantic_combine_kernel_is_bitwise_plain(cuda, p, n, d, offset):
    rng = np.random.default_rng(p * n + d)
    flat = torch.as_tensor(rng.standard_normal(p * n * d + offset),
                           dtype=torch.float32, device=cuda)
    z = flat[offset:].view(p, n, d)
    beta = torch.softmax(torch.as_tensor(rng.standard_normal(p),
                                         dtype=torch.float32, device=cuda), 0)
    before = tsem.semantic_combine.launches
    got = tsem.semantic_combine(z, beta)
    torch.cuda.synchronize()
    assert tsem.semantic_combine.launches == before + 1
    assert torch.equal(got, tsem.semantic_combine_plain(z, beta))


def _spmm_case(seed, n, m, k, d, weighted, device):
    """Rows 0 and every 7th have no live slot; masked slots name rows far
    past the table, which the kernel must never read."""
    rng = np.random.default_rng(seed)
    live = rng.random((n, k)) < 0.5
    mask = (rng.random((n, k)) * 2.0 if weighted else np.ones((n, k)))
    mask = (mask * live).astype(np.float32)
    mask[::7] = 0.0
    nbr = rng.integers(0, m, (n, k))
    nbr[mask == 0] = 1 << 30
    return (torch.as_tensor(rng.standard_normal((m, d)), dtype=torch.float32,
                            device=device),
            torch.as_tensor(nbr, dtype=torch.int32, device=device),
            torch.as_tensor(mask, device=device))


SPMM_SHAPES = [  # (N, M, K, D)
    (4278, 2081, 64, 64),  # an RGCN/imdb relation
    (37, 50, 9, 64),  # rows not a multiple of a block
    (100, 80, 70, 20),  # K spans three ballots; D under one column group
    (33, 10, 1, 1),  # K = 1, D = 1
    (50, 40, 12, 130),  # three 64-column groups, the last of 2
]


@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("mean", [True, False])
@pytest.mark.parametrize("shape", SPMM_SHAPES)
def test_segment_spmm_kernel_matches_plain_and_emulation(cuda, shape, mean,
                                                          weighted):
    h, nbr, mask = _spmm_case(6, *shape, weighted, cuda)
    before = tspmm.segment_spmm.launches
    got = tspmm.segment_spmm(h, nbr, mask, mean=mean)
    torch.cuda.synchronize()
    assert tspmm.segment_spmm.launches == before + 1
    emu = tspmm.segment_spmm_emulate(h, nbr, mask, mean=mean)
    assert torch.equal(got, emu)  # same slot order, same roundings
    safe = torch.where(mask != 0, nbr, 0)  # the plain gather reads them all
    torch.testing.assert_close(
        got, tspmm.segment_spmm_plain(h, safe, mask, mean=mean), **TOL)
    assert torch.all(got[::7] == 0)
    assert torch.equal(got, tspmm.segment_spmm(h, nbr, mask, mean=mean))


FFN_SHAPES = [  # (N, M, K, F, D); the kernel takes D = 64 only
    (2081, 4278, 64, 3066, 64),  # RGCN/imdb (M, md, D) at full width
    (37, 50, 9, 70, 64),  # rows and F not multiples of a block
    (20, 30, 1, 64, 64),  # K = 1, F one whole tile
    (33, 40, 40, 130, 64),  # K spans two ballots, three F-tiles
    (17, 25, 70, 100, 64),  # K spans three ballots
    (9, 12, 6, 5, 64),  # F below one tile
]


@pytest.mark.parametrize("mean", [True, False])
@pytest.mark.parametrize("shape", FFN_SHAPES)
def test_fused_fp_na_kernel_matches_plain(cuda, shape, mean):
    n, m, k, f, d = shape
    x, nbr, mask = _spmm_case(7, n, m, k, f, True, cuda)
    rng = np.random.default_rng(8)
    w = torch.as_tensor(rng.standard_normal((f, d)) / np.sqrt(f),
                        dtype=torch.float32, device=cuda)
    before = tffn.fused_fp_na.launches
    got = tffn.fused_fp_na(x, w, nbr, mask, mean=mean)
    torch.cuda.synchronize()
    assert tffn.fused_fp_na.launches == before + 1
    safe = torch.where(mask != 0, nbr, 0)
    want = tffn.fused_fp_na_plain(x, w, safe, mask, mean=mean)
    tol = dict(rtol=1e-5, atol=1e-5 * float(want.abs().max()))
    torch.testing.assert_close(got, want, **tol)
    assert torch.all(got[::7] == 0)
    assert torch.equal(got, tffn.fused_fp_na(x, w, nbr, mask, mean=mean))
    if f <= 130:  # the emulation loops over F on the host
        torch.testing.assert_close(
            got, tffn.fused_fp_na_emulate(x, w, nbr, mask, mean=mean), **tol)


def test_new_kernels_raise_instead_of_falling_back(cuda):
    h, nbr, mask = _spmm_case(9, 20, 10, 4, 8, False, cuda)
    before = (tspmm.segment_spmm.launches, tffn.fused_fp_na.launches)
    with pytest.raises(ValueError, match="int32"):
        ops.segment_spmm(h, nbr.long(), mask, use_pallas=True)
    with pytest.raises(RuntimeError, match="invalid argument"):  # D != 64
        ops.fused_fp_na(h, torch.zeros(8, 32, device=cuda), nbr, mask,
                        use_pallas=True)
    assert (tspmm.segment_spmm.launches,
            tffn.fused_fp_na.launches) == before
