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
kernel does.  ``fused_fp_na`` accumulates the product over F on the
tensor cores with a 3xTF32 split (about fp32's precision, in another order
than the plain version's matmul), so its error grows with F and with the
size of the terms: rtol = 1e-5 and an atol of 1e-5 times the largest
|output|.
``cached_gather`` moves rows and computes nothing: bitwise against its
plain version and its emulation.  ``semantic_scores`` sums the zW products
with FMA in feature order, the row scores per tile, then the tiles by a
lane-strided sum and a butterfly, where the plain version leaves both
orders to the matmul and the mean: atol = rtol = 1e-5, and bitwise against
a second run.
``segment_sum`` adds each segment's edges in edge order, one rounded add
after another, as the plain version's ``index_add_`` does on the CPU: it is
held bitwise against the plain version run on the CPU and against its
emulation, and against a second run.
``flash_attention`` and ``decode_attention`` are held against the
attention oracles at the reference's own kernel-test tolerances (2e-4 in
fp32, 2e-2 in bf16, whose oracle rounds the scores and P to bf16), and
against their emulations, which run the same tile or split loop in fp32 in
another summation order: atol = rtol = 1e-5 in fp32; in bf16 both round an
fp32 result to bf16, which may land one bf16 step apart (2e-2).  The
copy widths that the launchers pick from the row alignment give the same
bits (the arithmetic does not depend on how a row arrived).
"""
import ctypes

import numpy as np
import pytest
import torch

from repro_torch.kernels import build
from repro_torch.kernels import decode_attention as tdec
from repro_torch.kernels import feature_cache as tfc
from repro_torch.kernels import flash_attention as tflash
from repro_torch.kernels import fused_fp_na as tffn
from repro_torch.kernels import gat_na as tgat
from repro_torch.kernels import ops
from repro_torch.kernels import segment_spmm as tspmm
from repro_torch.kernels import segment_sum as tss
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
    (2, 40, 60, 64, 8, 8, 128),  # HAN/imdb widths: ~38 live slots a row,
    # several of the kernel's 8-slot gather batches
    (1, 4278, 68448, 16, 8, 8, 128),  # MAGNN/imdb's unstacked launch
]


def test_kernel_constants_agree_with_the_wrapper(cuda):
    lib = build.library()
    assert lib.gat_na_rows_per_block() == tgat.ROWS_PER_BLOCK
    assert lib.gat_na_max_features() == tgat.MAX_FEATURES
    props = torch.cuda.get_device_properties(cuda)
    assert props.shared_memory_per_block_optin == tgat.SMEM_LIMIT
    for hd in (1, 16, 32, 63, 64, 65, 96, 128, 200, 256):
        for hs in (1, 7, 128, 161, 764, 1656):
            assert lib.gat_na_smem_bytes(1, hd, hs) == tgat.smem_bytes(hd, hs)


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


def test_gat_na_kernel_across_gather_batches(cuda):
    """K = 64 with live counts 0, 1, 8, 9, 13, 31, 33, 47 and 64 a row:
    counts not a multiple of the gather batch, all 64 slots live and all
    masked; against plain and the emulation, with and without the
    epilogue, the same bits twice."""
    p, hd, hs, nbr, mask, sem = _case(19, 2, 90, 70, 64, 8, 8, 128, cuda)
    counts = [0, 1, 8, 9, 13, 31, 33, 47, 64]
    rng = np.random.default_rng(20)
    m = np.zeros((2, 90, 64), np.float32)
    for s in range(2):
        for r in range(90):
            m[s, r, rng.permutation(64)[:counts[(r + s) % 9]]] = 1.0
    mask = torch.as_tensor(m, device=cuda)
    dead = mask.sum(-1) == 0
    got = tgat.gat_na(p, hd, hs, nbr, mask)
    torch.testing.assert_close(got, tgat.gat_na_plain(p, hd, hs, nbr, mask),
                               **TOL)
    torch.testing.assert_close(
        got, tgat.gat_na_emulate(p, hd, hs, nbr, mask), **TOL)
    assert torch.all(got[dead] == 0)
    z, w = tgat.gat_na(p, hd, hs, nbr, mask, sem=sem)
    zp, wp = tgat.gat_na_plain(p, hd, hs, nbr, mask, sem)
    ze, we = tgat.gat_na_emulate(p, hd, hs, nbr, mask, sem=sem)
    torch.testing.assert_close(z, zp, **TOL)
    torch.testing.assert_close(w, wp, **TOL)
    torch.testing.assert_close(w, we, **TOL)
    z2, w2 = tgat.gat_na(p, hd, hs, nbr, mask, sem=sem)
    assert torch.equal(z, z2) and torch.equal(w, w2)
    assert torch.equal(z, torch.nn.functional.elu(got))


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
    (2, 1001, 2, 0),  # N*D % 4 == 2 on an aligned base: 4-byte vectors
    (8, 4278, 64, 0),  # eight metapaths on the 16-byte path
    (8, 33, 5, 2),  # eight metapaths, 8 bytes off, N*D odd
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


def test_segment_spmm_geometry_agrees_with_the_wrapper(cuda):
    g = (ctypes.c_int * 4)()
    build.library().segment_spmm_geometry(g)
    assert tuple(g) == (tspmm.ROWS, tspmm.WINDOW, tspmm.CHUNK, tspmm.STAGES)


SPMM_EDGES = {  # name: (N, M, K, D, h_src offset in floats, all slots live)
    # every row at 64 live slots: each block's list (1024 entries) runs
    # through the ring's 256 four times over
    "all_64_live": (70, 300, 64, 64, 0, True),
    "k65_windows": (50, 80, 65, 64, 0, False),  # a second window of 1 slot
    "k300_windows": (40, 90, 300, 64, 0, False),  # five windows
    "k300_all_live": (20, 60, 300, 33, 0, True),
    "offset_4_bytes": (60, 50, 64, 64, 1, False),  # 4-byte copies
    "offset_8_bytes": (45, 50, 40, 66, 2, False),  # 8-byte copies
    "d1": (33, 10, 64, 1, 0, False),
    "d20": (100, 80, 70, 20, 0, False),
    "d130": (50, 40, 12, 130, 0, False),  # three column groups, last of 2
}


@pytest.mark.parametrize("mean", [True, False])
@pytest.mark.parametrize("name", sorted(SPMM_EDGES))
def test_segment_spmm_kernel_edges_are_bitwise_the_emulation(cuda, name,
                                                             mean):
    """The block walk at its edges: lists past the ring, K across windows,
    the narrower copies of an h_src off 16 bytes, D of one column, under
    one group and over two; bitwise equal to the emulation and to a second
    run, one launch a call."""
    n, m, k, d, offset, full = SPMM_EDGES[name]
    h, nbr, mask = _spmm_case(26, n, m, k, d, True, cuda)
    if full:
        rng = np.random.default_rng(27)
        mask = torch.as_tensor(rng.random((n, k)) * 2.0 + 0.5,
                               dtype=torch.float32, device=cuda)
        nbr = torch.as_tensor(rng.integers(0, m, (n, k)), dtype=torch.int32,
                              device=cuda)
    if offset:
        flat = torch.zeros(m * d + offset, device=cuda)
        h_off = flat[offset:].view(m, d)
        h_off.copy_(h)
        assert h_off.data_ptr() % 16 != 0
        h = h_off
    before = tspmm.segment_spmm.launches
    got = tspmm.segment_spmm(h, nbr, mask, mean=mean)
    torch.cuda.synchronize()
    assert tspmm.segment_spmm.launches == before + 1
    assert torch.equal(got, tspmm.segment_spmm_emulate(h, nbr, mask,
                                                       mean=mean))
    assert torch.equal(got, tspmm.segment_spmm(h, nbr, mask, mean=mean))
    safe = torch.where(mask != 0, nbr, 0)
    torch.testing.assert_close(
        got, tspmm.segment_spmm_plain(h, safe, mask, mean=mean), **TOL)


FFN_SHAPES = [  # (N, M, K, F, D); the kernel takes D = 64 only
    (2081, 4278, 64, 3066, 64),  # RGCN/imdb (M, md, D) at full width
    (37, 50, 9, 70, 64),  # rows and F not multiples of a block
    (20, 30, 1, 64, 64),  # K = 1, F one whole tile
    (33, 40, 40, 130, 64),  # K spans two ballots, three F-tiles
    (17, 25, 70, 100, 64),  # K spans three ballots
    (9, 12, 6, 5, 64),  # F below one tile
    # F-slices (8 a row tile): 18 tiles in 6 slices of 3, the last tile of
    # 3 columns; 48 tiles in all 8 slices; row tiles of 64
    (45, 70, 20, 1091, 64),
    (70, 90, 12, 3066, 64),
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


def test_fused_fp_na_kernel_at_the_slot_cap(cuda):
    """Every row with all 64 slots live (a 64-row tile's slot list holds
    4096 entries, 128 of the ring's 32-entry chunks an F-tile), across
    every slice."""
    n, m, k, f = 70, 300, 64, 1091
    rng = np.random.default_rng(21)
    x = torch.as_tensor(rng.standard_normal((m, f)), dtype=torch.float32,
                        device=cuda)
    w = torch.as_tensor(rng.standard_normal((f, 64)) / np.sqrt(f),
                        dtype=torch.float32, device=cuda)
    nbr = torch.as_tensor(rng.integers(0, m, (n, k)), dtype=torch.int32,
                          device=cuda)
    mask = torch.as_tensor(rng.random((n, k)) * 2.0 + 0.5,
                           dtype=torch.float32, device=cuda)
    for mean in (True, False):
        got = tffn.fused_fp_na(x, w, nbr, mask, mean=mean)
        want = tffn.fused_fp_na_plain(x, w, nbr, mask, mean=mean)
        tol = dict(rtol=1e-5, atol=1e-5 * float(want.abs().max()))
        torch.testing.assert_close(got, want, **tol)
        torch.testing.assert_close(
            got, tffn.fused_fp_na_emulate(x, w, nbr, mask, mean=mean), **tol)
        assert torch.equal(got, tffn.fused_fp_na(x, w, nbr, mask, mean=mean))


@pytest.mark.parametrize("k,fits", [(334, True), (335, False)])
def test_fused_fp_na_kernel_at_its_widest_k(cuda, k, fits):
    """A row tile's slot list holds 64 * K entries in shared memory, so K =
    334 is the widest the launcher takes; K = 335 is refused without a
    launch, and the refusal leaves no error behind for the next launch."""
    n, m, f = 70, 90, 70
    x, nbr, mask = _spmm_case(23, n, m, k, f, True, cuda)
    rng = np.random.default_rng(24)
    w = torch.as_tensor(rng.standard_normal((f, 64)) / np.sqrt(f),
                        dtype=torch.float32, device=cuda)
    safe = torch.where(mask != 0, nbr, 0)
    before = tffn.fused_fp_na.launches
    if not fits:
        with pytest.raises(RuntimeError, match="fused_fp_na: CUDA error"):
            tffn.fused_fp_na(x, w, nbr, mask)
        assert tffn.fused_fp_na.launches == before
        k_ok = 334  # the next launches run
        x, nbr, mask = _spmm_case(23, n, m, k_ok, f, True, cuda)
        safe = torch.where(mask != 0, nbr, 0)
    got = tffn.fused_fp_na(x, w, nbr, mask)
    want = tffn.fused_fp_na_plain(x, w, safe, mask)
    torch.cuda.synchronize()
    tol = dict(rtol=1e-5, atol=1e-5 * float(want.abs().max()))
    torch.testing.assert_close(got, want, **tol)
    assert torch.all(got[::7] == 0)


@pytest.mark.parametrize("h,dh,hs,fits", [
    (8, 8, 764, True), (8, 8, 765, False),  # H*Dh = 64
    (16, 16, 160, True), (16, 16, 161, False),  # H*Dh = 256
])
def test_gat_na_epilogue_at_its_widest_hs(cuda, h, dh, hs, fits):
    """The epilogue keeps W (rows padded to 4) and each warp's z rows in
    shared memory: Hs = 764 at H*Dh = 64 and 160 at 256 are the widest the
    kernel takes.  One wider is refused without a launch, and the next
    launch runs."""
    p, hd, h_src, nbr, mask, sem = _case(25, 2, 60, 50, 20, h, dh, hs, cuda)
    before = tgat.gat_na.fused_launches
    if not fits:
        with pytest.raises(ValueError, match="shared memory"):
            tgat.gat_na(p, hd, h_src, nbr, mask, sem=sem)
        assert tgat.gat_na.fused_launches == before
        sem = {"W": sem["W"][:, :hs - 1].contiguous(),
               "b": sem["b"][:hs - 1].contiguous(),
               "q": sem["q"][:hs - 1].contiguous()}
    z, w = tgat.gat_na(p, hd, h_src, nbr, mask, sem=sem)
    torch.cuda.synchronize()
    zp, wp = tgat.gat_na_plain(p, hd, h_src, nbr, mask, sem)
    torch.testing.assert_close(z, zp, **TOL)
    torch.testing.assert_close(w, wp, **TOL)
    z2, w2 = tgat.gat_na(p, hd, h_src, nbr, mask, sem=sem)
    assert torch.equal(z, z2) and torch.equal(w, w2)


def test_fused_fp_na_constants_and_alignment(cuda):
    """The slice and row-tile counts agree with the wrapper's; a W off a
    16-byte boundary is refused before any launch."""
    assert build.library().fused_fp_na_slices() == tffn.SLICES
    assert build.library().fused_fp_na_rows() == tffn.ROWS
    h, nbr, mask = _spmm_case(22, 20, 10, 4, 8, False, cuda)
    buf = torch.zeros(8 * 64 + 1, device=cuda)
    w = buf[1:].view(8, 64)
    before = tffn.fused_fp_na.launches
    with pytest.raises(ValueError, match="16-byte"):
        tffn.fused_fp_na(h, w, nbr, mask)
    assert tffn.fused_fp_na.launches == before


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


def _gather_case(seed, n, d, c, shape, where, device):
    rng = np.random.default_rng(seed)
    lo, hi = {"hot": (n, n + c), "cold": (0, n), "mixed": (0, n + c)}[where]
    return (torch.as_tensor(rng.standard_normal((n, d)), dtype=torch.float32,
                            device=device),
            torch.as_tensor(rng.permutation(n)[:c], dtype=torch.int32,
                            device=device),
            torch.as_tensor(rng.integers(lo, hi, shape), dtype=torch.int32,
                            device=device))


GATHER_CASES = [  # (N, D, C, idx shape, where)
    (4278, 64, 256, (4278, 16), "mixed"),  # a MAGNN/imdb position
    (50, 16, 1, (37, 4), "mixed"),  # C = 1
    (40, 8, 6, (129,), "hot"),  # every index hot, 1-D, a ragged block
    (40, 8, 6, (20, 7), "cold"),  # every index cold
    (25, 3, 4, (11, 5), "mixed"),  # D not a multiple of 4: scalar copies
    (30, 70, 5, (9, 9), "mixed"),  # D = 70: a ragged float4 tail
]


@pytest.mark.parametrize("case", GATHER_CASES)
def test_cached_gather_kernel_is_bitwise_plain(cuda, case):
    table, hot, idx = _gather_case(10, *case, cuda)
    before = tfc.cached_gather.launches
    got = tfc.cached_gather(table, hot, idx)
    torch.cuda.synchronize()
    assert tfc.cached_gather.launches == before + 1
    assert torch.equal(got, tfc.cached_gather_plain(table, hot, idx))
    assert torch.equal(got, tfc.cached_gather_emulate(table, hot, idx))


def test_cached_gather_kernel_reads_strided_positions(cuda):
    """The three positions of a MAGNN instance table ``[N, I, 3]``, each a
    view with a column stride of 3, and an offset view of the table's
    storage (16-byte copies off)."""
    table, hot, _ = _gather_case(11, 300, 64, 32, (1,), "mixed", cuda)
    rng = np.random.default_rng(12)
    nodes = torch.as_tensor(rng.integers(0, 332, (70, 16, 3)),
                            dtype=torch.int32, device=cuda)
    for j in range(3):
        view = nodes[:, :, j]
        assert not view.is_contiguous()
        assert torch.equal(tfc.cached_gather(table, hot, view),
                           tfc.cached_gather_plain(table, hot, view))
    flat = torch.zeros(300 * 64 + 1, device=cuda)
    shifted = flat[1:].view(300, 64)
    shifted.copy_(table)
    idx = nodes[:, :, 1]
    assert torch.equal(tfc.cached_gather(shifted, hot, idx),
                       tfc.cached_gather_plain(table, hot, idx))


def _gather_edge(name, device):
    """``table`` (a view off 16 bytes for the scalar path), ``hot`` and
    ``idx`` for one edge of the fill-free gather."""
    rng = np.random.default_rng(28)
    n, d, c = (3000, 64, 1500) if name == "many_hot_ids" else (300, 64, 32)
    table = torch.as_tensor(rng.standard_normal((n, d)), dtype=torch.float32,
                            device=device)
    hot = torch.as_tensor(rng.permutation(n)[:c], dtype=torch.int32,
                          device=device)
    idx = torch.as_tensor(rng.integers(0, n + c, (70, 16)),
                          dtype=torch.int32, device=device)
    if name == "table_off_16_bytes":
        flat = torch.zeros(n * d + 1, device=device)
        table = flat[1:].view(n, d)
        table.copy_(torch.as_tensor(rng.standard_normal((n, d)),
                                    dtype=torch.float32, device=device))
        assert table.data_ptr() % 16 != 0
    elif name == "all_hot_c1":
        hot = hot[:1].clone()
        idx = torch.full((70, 16), n, dtype=torch.int32, device=device)
    elif name == "hot_id_n_minus_1":  # 32 distinct ids, N - 1 the last
        hot = torch.as_tensor(np.append(rng.permutation(n - 1)[:31], n - 1),
                              dtype=torch.int32, device=device)
        idx[:, 0] = n + 31
    return table, hot, idx


@pytest.mark.parametrize("name", ["table_off_16_bytes", "all_hot_c1",
                                  "hot_id_n_minus_1", "many_hot_ids"])
def test_cached_gather_kernel_edges_are_bitwise_plain(cuda, name):
    """The scalar path of a table off 16 bytes, every index hot with one
    hot row, the hot id N - 1, and 1500 hot ids: bitwise equal to the
    plain version, which fills the pool, and to the emulation, one launch
    a call."""
    table, hot, idx = _gather_edge(name, cuda)
    before = tfc.cached_gather.launches
    got = tfc.cached_gather(table, hot, idx)
    torch.cuda.synchronize()
    assert tfc.cached_gather.launches == before + 1
    assert torch.equal(got, tfc.cached_gather_plain(table, hot, idx))
    assert torch.equal(got, tfc.cached_gather_emulate(table, hot, idx))
    if name == "hot_id_n_minus_1":
        assert torch.equal(got[:, 0], table[-1].expand(idx.shape[0], -1))


def test_cached_gather_kernel_clamps_out_of_range_indices(cuda):
    table, hot, _ = _gather_case(13, 10, 4, 3, (1,), "mixed", cuda)
    idx = torch.tensor([-4, 0, 9, 10, 12, 13, 1 << 30], dtype=torch.int32,
                       device=cuda)
    got = tfc.cached_gather(table, hot, idx)
    torch.cuda.synchronize()
    assert torch.equal(got, tfc.cached_gather_emulate(table, hot, idx))


def _scores_case(seed, p, n, d, hs, device):
    rng = np.random.default_rng(seed)

    def t(a):
        return torch.as_tensor(a, dtype=torch.float32, device=device)

    return (t(rng.standard_normal((p, n, d))),
            t(rng.standard_normal((d, hs)) / np.sqrt(d)),
            t(rng.standard_normal(hs) * 0.1),
            t(rng.standard_normal(hs) / np.sqrt(hs)))


SCORES_SHAPES = [  # (P, N, D, Hs)
    (2, 4278, 64, 128),  # MAGNN/HAN SA at full width
    (1, 65, 64, 128),  # one metapath; one row past a block
    (3, 37, 16, 33),  # under one block; Hs not a multiple of 32
    (2, 200, 100, 7),  # D over 32 lanes twice plus a tail
    (1, 40, 8, 256),  # the widest Hs the kernel takes
    (4, 4278, 64, 128),  # no tile fits one wave: 64-row tiles, blocks
    # take 2-3, across metapaths
    (2, 300, 7, 40),  # D % 4 != 0: 4-byte copies of z, W padded
    (1, 50, 208, 256),  # the widest D at Hs = 256: seven ring chunks
    (1, 10000, 64, 128),  # on 132 SMs: 80-row tiles
    (1, 12000, 64, 100),  # 96-row tiles
    (1, 16000, 64, 128),  # 128-row tiles
]


@pytest.mark.parametrize("shape", SCORES_SHAPES)
def test_semantic_scores_kernel_matches_plain_and_emulation(cuda, shape):
    z, w, b, q = _scores_case(14, *shape, cuda)
    before = tsem.semantic_scores.launches
    got = tsem.semantic_scores(z, w, b, q)
    torch.cuda.synchronize()
    assert tsem.semantic_scores.launches == before + 1
    assert got.shape == (shape[0],)
    torch.testing.assert_close(got, tsem.semantic_scores_plain(z, w, b, q),
                               **TOL)
    tile = tsem.tile_rows(z, w)
    assert tile in (64, 72, 80, 96, 128)
    torch.testing.assert_close(
        got, tsem.semantic_scores_emulate(z, w, b, q, tile), **TOL)
    assert torch.equal(got, tsem.semantic_scores(z, w, b, q))  # no atomics


@pytest.mark.parametrize("w_off,z_off", [(1, 0), (0, 1), (3, 2)])
def test_semantic_scores_kernel_takes_unaligned_inputs(cuda, w_off, z_off):
    """W or z off a 16-byte boundary: the 4-byte copies give a result
    within tolerance of plain, and the bits of the aligned inputs."""
    z, w, b, q = _scores_case(19, 2, 4278, 64, 128, cuda)
    want = tsem.semantic_scores(z, w, b, q)

    def shifted(t, off):
        flat = torch.empty(t.numel() + off, dtype=t.dtype, device=cuda)
        flat[off:] = t.reshape(-1)
        return flat[off:].view(t.shape)

    got = tsem.semantic_scores(shifted(z, z_off), shifted(w, w_off), b, q)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, tsem.semantic_scores_plain(z, w, b, q),
                               **TOL)
    assert torch.equal(got, want)


def test_semantic_scores_kernel_after_a_refused_launch(cuda):
    """A launch the C launcher refuses (W too wide for shared memory)
    returns its error and leaves none pending; the next calls give the bits
    of the calls before it, so the last-block counter was left at 0."""
    z, w, b, q = _scores_case(20, 2, 4278, 64, 128, cuda)
    first = tsem.semantic_scores(z, w, b, q)
    lib = build.library()
    d_big = 1000
    assert lib.semantic_scores_smem_bytes(d_big, 256) > tsem.SMEM_LIMIT
    zb = torch.zeros((1, 8, d_big), device=cuda)
    wb = torch.zeros((d_big, 256), device=cuda)
    vb = torch.zeros(256, device=cuda)
    scratch = torch.zeros(16, device=cuda)
    done = torch.zeros(1, dtype=torch.int32, device=cuda)
    out = torch.empty(1, device=cuda)
    err = lib.semantic_scores_launch(
        zb.data_ptr(), wb.data_ptr(), vb.data_ptr(), vb.data_ptr(),
        scratch.data_ptr(), done.data_ptr(), out.data_ptr(), 1, 8, d_big,
        256, torch.cuda.current_stream(cuda).cuda_stream)
    assert err != 0
    for _ in range(2):
        assert torch.equal(tsem.semantic_scores(z, w, b, q), first)
    torch.cuda.synchronize()


def test_semantic_scores_constants_agree_with_the_wrapper(cuda):
    lib = build.library()
    n_sm = torch.cuda.get_device_properties(cuda).multi_processor_count
    for p, n, hs in ((2, 4278, 128), (1, 10, 128), (2, 4278, 256),
                     (8, 4278, 128)):
        tile = lib.semantic_scores_tile_rows(p, n, 64, hs)
        # the least of 64, 72, 80, 96, 128 rows that fits one wave (64
        # where none does, or where Hs > 128)
        fits = [t for t in (64, 72, 80, 96, 128)
                if p * -(-n // t) <= n_sm] if hs <= 128 else []
        assert tile == (fits[0] if fits else 64)
    for d in (1, 7, 8, 64, 100, 208, 1000):
        for hs in (1, 7, 33, 128, 129, 256):
            assert lib.semantic_scores_smem_bytes(d, hs) == tsem.smem_bytes(
                d, hs)


def test_semantic_attention_kernel_arm_matches_plain(cuda):
    z, w, b, q = _scores_case(15, 2, 4278, 64, 128, cuda)
    before = (tsem.semantic_scores.launches, tsem.semantic_combine.launches)
    got = ops.semantic_attention(z, w, b, q, use_pallas=True)
    torch.cuda.synchronize()
    assert (tsem.semantic_scores.launches,
            tsem.semantic_combine.launches) == (before[0] + 1, before[1] + 1)
    torch.testing.assert_close(
        got, ops.semantic_attention(z, w, b, q, use_pallas=False), **TOL)


@pytest.mark.parametrize("n,i,h,dh", [(4278, 16, 8, 8), (37, 5, 4, 8),
                                      (20, 3, 2, 16)])
def test_gat_na_unstacked_kernel_matches_plain(cuda, n, i, h, dh):
    """MAGNN's call: the encoded instances as the source pool, an
    ``arange`` grid, every seventh row with no live instance."""
    rng = np.random.default_rng(16)

    def t(a):
        return torch.as_tensor(a, dtype=torch.float32, device=cuda)

    p = {"a_dst": t(rng.standard_normal((h, dh)) * 0.3),
         "a_src": t(rng.standard_normal((h, dh)) * 0.3)}
    h_dst, h_src = (t(rng.standard_normal((n, h, dh))),
                    t(rng.standard_normal((n * i, h, dh))))
    nbr = torch.arange(n * i, dtype=torch.int32, device=cuda).reshape(n, i)
    mask = (rng.random((n, i)) < 0.4).astype(np.float32)
    mask[::7] = 0.0
    mask = t(mask)
    before = tgat.gat_na.launches
    got = ops.gat_aggregate(p, h_dst, h_src, nbr, mask, use_pallas=True)
    torch.cuda.synchronize()
    assert tgat.gat_na.launches == before + 1
    assert got.shape == (n, h, dh)
    torch.testing.assert_close(
        got, ops.gat_aggregate(p, h_dst, h_src, nbr, mask), **TOL)
    torch.testing.assert_close(
        got, tgat.gat_na_emulate(p, h_dst, h_src, nbr, mask), **TOL)
    assert torch.all(got[::7] == 0)


def test_slice3_kernels_raise_instead_of_falling_back(cuda):
    table, hot, idx = _gather_case(17, 20, 8, 3, (5, 2), "mixed", cuda)
    z, w, b, q = _scores_case(18, 2, 30, 16, 8, cuda)
    before = (tfc.cached_gather.launches, tsem.semantic_scores.launches)
    with pytest.raises(ValueError, match="int32"):
        ops.cached_gather(table, hot, idx.long(), use_pallas=True)
    with pytest.raises(ValueError, match="contiguous"):
        ops.cached_gather(table.t(), hot, idx, use_pallas=True)
    with pytest.raises(ValueError, match="float32"):
        ops.semantic_attention(z.double(), w, b, q, use_pallas=True)
    with pytest.raises(ValueError, match="contiguous"):
        ops.semantic_attention(z.transpose(1, 2).contiguous().transpose(
            1, 2), w, b, q, use_pallas=True)
    assert (tfc.cached_gather.launches,
            tsem.semantic_scores.launches) == before


ATTN_TOL = {torch.float32: dict(atol=2e-4, rtol=2e-4),
            torch.bfloat16: dict(atol=2e-2, rtol=2e-2)}
EMU_TOL = {torch.float32: dict(atol=1e-5, rtol=1e-5),
           torch.bfloat16: dict(atol=2e-2, rtol=2e-2)}


def _attn(rng, shape, dtype, device):
    return torch.as_tensor(rng.standard_normal(shape) * 0.5,
                           dtype=torch.float32, device=device).to(dtype)


FLASH_SHAPES = [  # (B, S, H, KVH, Dh)
    (1, 100, 4, 4, 20),  # G = 1, S a tail of two tiles, Dh = 20
    (2, 130, 6, 2, 64),  # G = 3, a 2-row tail tile
    (1, 256, 8, 2, 120),  # G = 4, Dh = 120 (h2o-danube)
    (2, 200, 8, 2, 128),  # G = 4, Dh = 128 (granite), a tail
    (1, 64, 3, 1, 128),  # G = 3, one tile
]
FLASH_MODES = [(True, 0), (False, 0), (True, 40), (False, 40)]
# the bf16 kernel's two-stage K ring gone round at least twice (five or more
# kv tiles), with each copy width (16-byte at Dh % 8 == 0, 4-byte at even
# Dh, 2-byte at odd Dh) and each padded depth (64, 128)
FLASH_RING_SHAPES = [  # (B, S, H, KVH, Dh)
    (1, 321, 8, 2, 128),  # G = 4, S one past a tile
    (1, 300, 4, 4, 40),  # depth 64, zero-padded
    (2, 257, 2, 1, 7),  # odd Dh: 2-byte copies, depth 64
    (1, 330, 4, 2, 100),  # even Dh: 4-byte copies, depth 128
]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("causal,window", FLASH_MODES)
@pytest.mark.parametrize("shape", FLASH_SHAPES + FLASH_RING_SHAPES)
def test_flash_attention_kernel_matches_plain_and_emulation(
        cuda, shape, causal, window, dtype):
    b, s, h, kvh, dh = shape
    rng = np.random.default_rng(b * s + h + dh)
    q = _attn(rng, (b, s, h, dh), dtype, cuda)
    k = _attn(rng, (b, s, kvh, dh), dtype, cuda)
    v = _attn(rng, (b, s, kvh, dh), dtype, cuda)
    before = tflash.flash_attention.launches
    got = tflash.flash_attention(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    assert tflash.flash_attention.launches == before + 1
    assert got.dtype == dtype and got.shape == q.shape
    assert torch.isfinite(got).all()
    want = tflash.flash_attention_plain(q, k, v, causal=causal,
                                        window=window)
    torch.testing.assert_close(got.float(), want.float(), **ATTN_TOL[dtype])
    emu = tflash.flash_attention_emulate(q, k, v, causal=causal,
                                         window=window)
    torch.testing.assert_close(got.float(), emu.float(), **EMU_TOL[dtype])
    again = tflash.flash_attention(q, k, v, causal=causal, window=window)
    assert torch.equal(got, again)  # no atomics: the same bits


DECODE_CASES = [  # (B, S, H, KVH, Dh, kv_len)
    (3, 100, 4, 4, 20, [1, 57, 100]),  # G = 1, kv_len 1 and S
    (2, 300, 6, 2, 64, [300, 129]),  # G = 3, a split boundary + 1
    (2, 129, 12, 4, 120, [128, 129]),  # G = 3, Dh = 120, S past a split
    (4, 2080, 32, 8, 128, [1, 1000, 2049, 2080]),  # the granite decode
    (1, 64, 4, 1, 128, [64]),  # G = 4, one tile
]
# 64-row splits (a warp each) of 8-row tiles through a four-stage ring: a
# full split goes round the ring twice; kv_len one past a split (257) or a
# tile (33); each copy width
DECODE_RING_CASES = [  # (B, S, H, KVH, Dh, kv_len)
    (2, 600, 8, 2, 128, [257, 600]),  # G = 4, ten splits
    (1, 530, 4, 1, 40, [530]),  # Dh 40
    (2, 290, 6, 2, 20, [33, 290]),  # Dh 20: 4-byte copies in bf16
    (1, 300, 3, 1, 7, [299]),  # odd Dh: 2-byte copies in bf16
    (2, 520, 16, 2, 64, [520, 513]),  # G = 8: two passes of 4 heads
]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", DECODE_CASES + DECODE_RING_CASES)
def test_decode_attention_kernel_matches_plain_and_emulation(cuda, case,
                                                             dtype):
    b, s, h, kvh, dh, lens = case
    rng = np.random.default_rng(b * s + h + dh)
    q = _attn(rng, (b, h, dh), dtype, cuda)
    k = _attn(rng, (b, s, kvh, dh), dtype, cuda)
    v = _attn(rng, (b, s, kvh, dh), dtype, cuda)
    kv_len = torch.tensor(lens, dtype=torch.int32, device=cuda)
    before = tdec.decode_attention.launches
    got = tdec.decode_attention(q, k, v, kv_len)
    torch.cuda.synchronize()
    assert tdec.decode_attention.launches == before + 1
    assert got.dtype == dtype and got.shape == q.shape
    want = tdec.decode_attention_plain(q, k, v, kv_len)
    torch.testing.assert_close(got.float(), want.float(), **ATTN_TOL[dtype])
    emu = tdec.decode_attention_emulate(q, k, v, kv_len)
    torch.testing.assert_close(got.float(), emu.float(), **EMU_TOL[dtype])
    assert torch.equal(got, tdec.decode_attention(q, k, v, kv_len))
    # a row at or past kv_len is never read: NaN there changes nothing
    kp, vp = k.clone(), v.clone()
    for i, n in enumerate(lens):
        kp[i, n:] = float("nan")
        vp[i, n:] = float("nan")
    assert torch.equal(tdec.decode_attention(q, kp, vp, kv_len), got)


def _unaligned(t):
    """``t``'s values in a contiguous tensor whose start is one element
    past an aligned allocation: no 16- or 4-byte copy fits its rows."""
    buf = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
    out = buf[1:].view(t.shape)
    out.copy_(t)
    return out


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_attention_kernels_take_unaligned_rows(cuda, dtype):
    """Rows that start off a 16-byte boundary take the narrow copies (the
    launchers pick the copy width from the pointers, not only from Dh)."""
    rng = np.random.default_rng(16)
    q = _attn(rng, (1, 300, 8, 128), dtype, cuda)
    k = _attn(rng, (1, 300, 2, 128), dtype, cuda)
    v = _attn(rng, (1, 300, 2, 128), dtype, cuda)
    uq, uk, uv = _unaligned(q), _unaligned(k), _unaligned(v)
    assert uk.data_ptr() % 16
    want = tflash.flash_attention(q, k, v)
    torch.testing.assert_close(tflash.flash_attention(uq, uk, uv).float(),
                               want.float(), atol=0, rtol=0)
    kv_len = torch.tensor([290], dtype=torch.int32, device=cuda)
    want = tdec.decode_attention(q[:, 0], k, v, kv_len)
    got = tdec.decode_attention(_unaligned(q[:, 0].contiguous()), uk, uv,
                                kv_len)
    torch.testing.assert_close(got.float(), want.float(), atol=0, rtol=0)


def test_attention_kernels_refuse_what_they_do_not_take(cuda):
    q = torch.zeros((1, 64, 2, 136), device=cuda)
    before = (tflash.flash_attention.launches,
              tdec.decode_attention.launches)
    with pytest.raises(ValueError, match="head dim"):
        ops.flash_attention(q, q, q, use_pallas=True)
    kv_len = torch.ones(1, dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError, match="head dim"):
        ops.decode_attention(q[:, 0], q, q, kv_len, use_pallas=True)
    q = torch.zeros((1, 64, 2, 64), device=cuda)
    with pytest.raises(ValueError, match="int32"):
        ops.decode_attention(q[:, 0], q, q, kv_len.long(), use_pallas=True)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        ops.flash_attention(q.half(), q.half(), q.half(), use_pallas=True)
    assert (tflash.flash_attention.launches,
            tdec.decode_attention.launches) == before


def _ssum_case(seed, e, n, c, m, heavy=0):
    """(vals [E, C], table [M, C], idx [E], seg [E] sorted) with empty
    segments, one segment of ``heavy`` extra edges and values of mixed
    magnitude, so that the order of the sums shows in the bits."""
    rng = np.random.default_rng(seed)
    seg = rng.integers(0, n, e)
    if heavy:
        seg = np.concatenate([seg, np.full(heavy, n // 3)])
    seg = np.sort(seg[seg % 5 != 2]).astype(np.int32)
    scale = np.exp(rng.uniform(-6, 6, (len(seg), 1)))
    vals = (rng.standard_normal((len(seg), c)) * scale).astype(np.float32)
    table = rng.standard_normal((m, c)).astype(np.float32)
    idx = rng.integers(0, m, len(seg)).astype(np.int32)
    return vals, table, idx, seg


SSUM_SHAPES = [  # (E, N, C, M, heavy)
    (0, 5, 8, 4, 0),  # no edge: every segment 0
    (40, 40, 1, 10, 0),  # one column, single-edge segments
    (3000, 400, 8, 100, 0),  # the csr GAT's denominator [E, H]
    (5000, 300, 64, 500, 2000),  # its SpMM [E, H*Dh]; a 2000-edge segment
    (2000, 50, 300, 70, 33),  # wider than a 256-column block
    (200000, 23296, 64, 23296, 0),  # GCN/Reddit-like: 8.6 edges a segment
    (20000, 40, 300, 100, 3000),  # every segment long; two column blocks
    (30000, 60, 63, 200, 0),  # long segments, C % 4 != 0: 4-byte copies
    (200000, 500, 8, 1000, 0),  # 500 long segments: more than the blocks
]


def test_segment_sum_long_edges_agree_with_the_wrapper(cuda):
    assert build.library().segment_sum_long_edges() == tss.LONG


@pytest.mark.parametrize("gather", [False, True])
def test_segment_sum_kernel_at_the_long_boundary(cuda, gather):
    """Segments of LONG - 1, LONG, LONG + 1 edges and one of 5 ring
    stages and a row, beside empty and short ones: the two kernels split
    at LONG, and a second call (the counters back at 0) gives the same
    bits."""
    lens = [0, tss.LONG - 1, 3, tss.LONG, 0, tss.LONG + 1, 1, 5 * 32 + 1]
    seg = np.repeat(np.arange(len(lens)), lens).astype(np.int32)
    vals, table, idx, _ = _ssum_case(7, len(seg), 1, 64, 90)
    vals = vals[:len(seg)]
    src = torch.as_tensor(table if gather else vals, device=cuda)
    s = torch.as_tensor(seg, device=cuda)
    i = torch.as_tensor(idx[:len(seg)], device=cuda) if gather else None
    got = tss.segment_sum(src, s, len(lens), idx=i, mean=True)
    want = tss.segment_sum_plain(src.cpu(), s.cpu(), len(lens),
                                 idx=None if i is None else i.cpu(),
                                 mean=True)
    assert torch.equal(got.cpu(), want)
    assert torch.equal(got, tss.segment_sum(src, s, len(lens), idx=i,
                                            mean=True))


@pytest.mark.parametrize("mean", [False, True])
@pytest.mark.parametrize("gather", [False, True])
@pytest.mark.parametrize("shape", SSUM_SHAPES)
def test_segment_sum_kernel_is_bitwise_plain(cuda, shape, gather, mean):
    e, n, c, m, heavy = shape
    vals, table, idx, seg = _ssum_case(sum(shape), e, n, c, m, heavy)
    src = table if gather else vals
    args = [torch.as_tensor(a, device=cuda) for a in (src, seg)]
    i = torch.as_tensor(idx, device=cuda) if gather else None
    before = tss.segment_sum.launches
    got = tss.segment_sum(*args, n, idx=i, mean=mean)
    torch.cuda.synchronize()
    assert tss.segment_sum.launches == before + 1
    cpu = [a.cpu() for a in args]
    want = tss.segment_sum_plain(*cpu, n, idx=None if i is None else i.cpu(),
                                 mean=mean)
    assert torch.equal(got.cpu(), want)
    assert torch.equal(got, tss.segment_sum(*args, n, idx=i, mean=mean))
    if e <= 5000:
        assert torch.equal(got.cpu(), tss.segment_sum_emulate(
            *cpu, n, idx=None if i is None else i.cpu(), mean=mean))
    empty = np.setdiff1d(np.arange(n), seg)
    assert torch.all(got[torch.as_tensor(empty, device=cuda)] == 0)


def test_segment_sum_kernel_drops_segments_past_n(cuda):
    """Edges whose segment id is n or more are never reached, as
    ``jax.ops.segment_sum(num_segments=n)`` drops them."""
    vals, _, _, seg = _ssum_case(3, 500, 30, 8, 1)
    seg[-40:] = 30 + np.arange(40) // 10  # sorted, past the last segment
    v, s = (torch.as_tensor(a, device=cuda) for a in (vals, seg))
    got = tss.segment_sum(v, s, 30)
    keep = seg < 30
    want = tss.segment_sum_plain(torch.as_tensor(vals[keep]),
                                 torch.as_tensor(seg[keep]), 30)
    assert torch.equal(got.cpu(), want)


def test_segment_sum_kernel_raises_instead_of_falling_back(cuda):
    vals, table, idx, seg = _ssum_case(4, 300, 20, 8, 30)
    v, t, i, s = (torch.as_tensor(a, device=cuda)
                  for a in (vals, table, idx, seg))
    before = tss.segment_sum.launches
    with pytest.raises(ValueError, match="int32"):
        tss.segment_sum(v, s.long(), 20)
    with pytest.raises(ValueError, match="int32"):
        tss.segment_sum(t, s, 20, idx=i.long(), mean=True)
    with pytest.raises(ValueError, match="float32"):
        tss.segment_sum(v.double(), s, 20)
    with pytest.raises(ValueError, match="contiguous"):
        tss.segment_sum(v.t().contiguous().t(), s, 20)
    with pytest.raises(ValueError, match="empty"):
        tss.segment_sum(v, s, 0)
    assert tss.segment_sum.launches == before


@pytest.mark.parametrize("n,k", [(1, 8), (3, 8), (5, 16), (40, 24), (7, 64),
                                 (300, 8)])
def test_gat_na_unstacked_at_bucket_shapes(cuda, n, k):
    """HAN's bucketed call: one degree bucket's gathered rows (few of
    them, fewer than a block's warps) against the whole target table at
    a cap K below the 32-slot ballot; every third row with a single live
    slot, one row with none."""
    rng = np.random.default_rng(n * k)

    def t(a):
        return torch.as_tensor(a, dtype=torch.float32, device=cuda)

    p = {"a_dst": t(rng.standard_normal((8, 8)) * 0.3),
         "a_src": t(rng.standard_normal((8, 8)) * 0.3)}
    table = t(rng.standard_normal((500, 8, 8)))
    rows = torch.as_tensor(rng.choice(500, n, replace=False),
                           dtype=torch.long, device=cuda)
    h_dst = table.index_select(0, rows)
    nbr = torch.as_tensor(rng.integers(0, 500, (n, k)), dtype=torch.int32,
                          device=cuda)
    mask = (rng.random((n, k)) < 0.7).astype(np.float32)
    mask[::3] = 0.0
    mask[::3, 0] = 1.0
    mask[n // 2] = 0.0
    mask = t(mask)
    before = tgat.gat_na.launches
    got = ops.gat_aggregate(p, h_dst, table, nbr, mask, use_pallas=True)
    torch.cuda.synchronize()
    assert tgat.gat_na.launches == before + 1 and got.shape == (n, 8, 8)
    torch.testing.assert_close(
        got, ops.gat_aggregate(p, h_dst, table, nbr, mask), **TOL)
    torch.testing.assert_close(
        got, tgat.gat_na_emulate(p, h_dst, table, nbr, mask), **TOL)
    assert torch.all(got[n // 2] == 0)
    assert torch.equal(got, ops.gat_aggregate(p, h_dst, table, nbr, mask,
                                              use_pallas=True))


def test_gat_na_refuses_an_empty_bucket(cuda):
    p = {"a_dst": torch.zeros((8, 8), device=cuda),
         "a_src": torch.zeros((8, 8), device=cuda)}
    table = torch.zeros((10, 8, 8), device=cuda)
    before = tgat.gat_na.launches
    with pytest.raises(ValueError, match="empty"):
        ops.gat_aggregate(p, table[:0], table,
                          torch.zeros((0, 8), dtype=torch.int32, device=cuda),
                          torch.zeros((0, 8), device=cuda), use_pallas=True)
    assert tgat.gat_na.launches == before


def _rung_buckets(n, caps, all_pad, rng, device):
    """Degree buckets as the sampler pads them to a rung: ``n`` rows
    each, the pad rows all masked with row id ``n`` (the sink); with
    ``all_pad`` the first bucket has no real row at all."""
    rows = rng.permutation(n - 2)
    parts = np.array_split(rows, len(caps))
    if all_pad:
        parts = [rows[:0], *np.array_split(rows, len(caps) - 1)]
    out = []
    for part, k in zip(parts, caps):
        rid = np.full(n, n, np.int32)
        rid[:len(part)] = part
        nbr = rng.integers(0, n, (n, k)).astype(np.int32)
        mask = (rng.random((n, k)) < 0.6).astype(np.float32)
        nbr[len(part):] = 0
        mask[len(part):] = 0.0
        out.append(tuple(torch.as_tensor(a, device=device)
                         for a in (rid, nbr, mask)))
    return out


@pytest.mark.parametrize("all_pad", [True, False])
def test_sampled_bucket_arms_on_the_card(cuda, all_pad):
    """A sampled rung's buckets through the bucketed GAT and mean arms on
    the kernels (``gat_na`` unstacked, ``segment_spmm``): an all-pad
    bucket comes out exactly 0 and lands in the sink row with every other
    pad, the real rows agree with the CPU's plain arm, and the context
    stays usable (no device assert)."""
    from repro_torch.core import stages

    rng = np.random.default_rng(23)
    n = 136
    bks = _rung_buckets(n, (4, 8, 16), all_pad, rng, cuda)
    h = torch.as_tensor(rng.standard_normal((n, 8, 8)), dtype=torch.float32,
                        device=cuda)
    p = {"a_dst": torch.as_tensor(rng.standard_normal((8, 8)) * 0.3,
                                  dtype=torch.float32, device=cuda),
         "a_src": torch.as_tensor(rng.standard_normal((8, 8)) * 0.3,
                                  dtype=torch.float32, device=cuda)}
    gat = lambda *a: ops.gat_aggregate(*a, use_pallas=True)  # noqa: E731
    spmm = lambda hs, nb, mk: ops.segment_spmm(  # noqa: E731
        hs, nb, mk, use_pallas=True)
    if all_pad:
        rid, nbr, mask = bks[0]
        assert bool((rid == n).all()) and float(mask.sum()) == 0.0
        assert torch.all(ops.gat_aggregate(p, h, h, nbr, mask,
                                           use_pallas=True) == 0)
        assert torch.all(spmm(h.reshape(n, -1), nbr, mask) == 0)
    before = (tgat.gat_na.launches, tspmm.segment_spmm.launches)
    z = stages.gat_aggregate_bucketed(p, h, h, bks, agg_fn=gat, sink=True)
    m = stages.mean_aggregate_bucketed(h.reshape(n, -1), bks, n,
                                       agg_fn=spmm, sink=True)
    torch.cuda.synchronize()
    assert (tgat.gat_na.launches, tspmm.segment_spmm.launches) == (
        before[0] + 3, before[1] + 3)
    cpu = [tuple(a.cpu() for a in b) for b in bks]
    p_cpu = {k: v.cpu() for k, v in p.items()}
    torch.testing.assert_close(z.cpu(), stages.gat_aggregate_bucketed(
        p_cpu, h.cpu(), h.cpu(), cpu, sink=True), **TOL)
    torch.testing.assert_close(m.cpu(), stages.mean_aggregate_bucketed(
        h.cpu().reshape(n, -1), cpu, n, sink=True), **TOL)
    dead = torch.ones(n, dtype=torch.bool, device=cuda)
    for rid, _, _ in bks:
        dead[rid[rid < n].long()] = False
    assert int(dead.sum()) == 2
    assert torch.all(z[dead] == 0) and torch.all(m[dead] == 0)
    assert float(torch.ones(4, device=cuda).sum()) == 4.0


@pytest.mark.parametrize("pads", [0, 1, 40, 600])
def test_segment_sum_kernel_sums_a_sink_segment(cuda, pads):
    """A sampled edge list: real edges sorted, then ``pads`` pad edges
    naming segment ``n`` (row 0 gathered).  The kernel sums them as one
    more segment — the sink, a long one past LONG edges — bitwise the
    plain version on the CPU, and the real segments equal the list
    without pads."""
    from repro_torch.core import stages

    vals, table, idx, seg = _ssum_case(31, 900, 70, 64, 80, 0)
    seg = np.concatenate([seg, np.full(pads, 70, np.int32)])
    idx = np.concatenate([idx[:len(seg) - pads],
                          np.zeros(pads, np.int32)])
    t, s, i = (torch.as_tensor(a, device=cuda) for a in (table, seg, idx))
    got = tss.segment_sum(t, s, 71, idx=i, mean=True)
    want = tss.segment_sum_plain(t.cpu(), s.cpu(), 71, idx=i.cpu(),
                                 mean=True)
    assert torch.equal(got.cpu(), want)
    real = len(seg) - pads
    assert torch.equal(got[:70], tss.segment_sum(t, s[:real], 70,
                                                 idx=i[:real], mean=True))
    arm = stages.mean_aggregate_csr(t, s, i, 70, sink=True)
    assert arm.shape == (70, 64) and torch.equal(arm, got[:70])
