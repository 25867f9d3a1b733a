"""Padded-neighbour aggregation of the port (``kernels/segment_spmm.py``,
``kernels/ref.py``, ``kernels/ops.py``) against the reference: the JAX
oracle and the Pallas kernel run in interpret mode, resident and streaming,
as ``tests/test_gat_na.py`` runs them.

Tolerance: atol = rtol = 1e-5 in fp32.  The Pallas kernel and the
emulation add the slots one by one in slot order, the plain versions sum
the ``[N, K, D]`` product in another order; that moves the last bits only.
The emulation follows the CUDA kernel's walk (blocks of rows, windows of
slots, the compacted list, ring chunks), and is held bitwise against the
slot-by-slot walk of the kernel before it (:func:`_slot_by_slot`).  The
CUDA kernel itself runs only on a card
(``tests/test_torch_kernels_gpu.py``)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro.kernels.segment_spmm import segment_spmm as pallas_spmm
from repro_torch.kernels import ops, ref
from repro_torch.kernels import segment_spmm as tspmm

TOL = dict(atol=1e-5, rtol=1e-5)


def _case(seed, n, m, k, d, weighted=False):
    """Inputs from a numpy seed; rows 0, 5 and n-1 have no live slot."""
    rng = np.random.default_rng(seed)
    h = rng.standard_normal((m, d)).astype(np.float32)
    nbr = rng.integers(0, m, (n, k)).astype(np.int32)
    live = rng.random((n, k)) < 0.6
    mask = (rng.random((n, k)) * 2.0 if weighted else np.ones((n, k)))
    mask = (mask * live).astype(np.float32)
    mask[[0, min(5, n - 1), n - 1]] = 0.0
    return h, nbr, mask


CASES = [  # (N, M, K, D): N never a multiple of the Pallas block (128)
    (150, 130, 9, 64),  # the RGCN width
    (45, 60, 33, 20),  # K spans two ballots of 32; D not a multiple of 32
    (70, 70, 1, 7),  # K = 1
    (33, 300, 5, 100),  # D over one 64-column group
]


def _slot_by_slot(h_src, nbr, mask, mean=True):
    """The walk of the kernel before the block-gathered one (one warp a
    row): slots j = 0..K-1 in order, a masked slot skipped without reading
    ``h_src``, ``acc = acc + row * m`` and ``deg = deg + m`` rounded step by
    step, then ``acc / max(deg, 1)``."""
    n, k = nbr.shape
    acc = torch.zeros((n, h_src.shape[1]), dtype=torch.float32)
    deg = torch.zeros((n, 1), dtype=torch.float32)
    for j in range(k):
        m = mask[:, j:j + 1].to(torch.float32)
        live = m != 0
        idx = torch.where(live[:, 0], nbr[:, j].long(), 0)
        acc = torch.where(live, acc + h_src[idx] * m, acc)
        deg = torch.where(live, deg + m, deg)
    if mean:
        acc = acc / torch.clamp(deg, min=1.0)
    return acc


def _reference(h, nbr, mask, mean, streaming):
    jh, jn, jm = jnp.asarray(h), jnp.asarray(nbr), jnp.asarray(mask)
    want = np.asarray(jref.segment_spmm(jh, jn, jm, mean=mean))
    kw = dict(block_n=16, block_m=64) if streaming else {}
    got = np.asarray(pallas_spmm(jh, jn, jm, mean=mean, interpret=True, **kw))
    return want, got


@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("mean", [True, False])
@pytest.mark.parametrize("case", CASES)
def test_plain_and_emulation_match_jax_ref_and_pallas(case, mean, weighted):
    h, nbr, mask = _case(1, *case, weighted=weighted)
    want, pallas = _reference(h, nbr, mask, mean, streaming=False)
    np.testing.assert_allclose(pallas, want, **TOL)
    th, tn, tm = map(torch.from_numpy, (h, nbr, mask))
    plain = ref.segment_spmm(th, tn, tm, mean=mean).numpy()
    emu = tspmm.segment_spmm_emulate(th, tn, tm, mean=mean).numpy()
    np.testing.assert_allclose(plain, want, **TOL)
    np.testing.assert_allclose(emu, pallas, **TOL)
    for out in (plain, emu):
        assert (out[[0, 5, -1]] == 0).all()  # exactly 0, not NaN


@pytest.mark.parametrize("mean", [True, False])
def test_emulation_matches_the_streaming_pallas_kernel(mean):
    h, nbr, mask = _case(2, 57, 300, 9, 33, weighted=True)
    _, streaming = _reference(h, nbr, mask, mean, streaming=True)
    emu = tspmm.segment_spmm_emulate(torch.from_numpy(h),
                                     torch.from_numpy(nbr),
                                     torch.from_numpy(mask), mean=mean)
    np.testing.assert_allclose(emu.numpy(), streaming, **TOL)


def test_emulation_adds_in_slot_order_and_never_reads_masked_slots():
    """Slot order, step by step: the emulation equals a Python fold over
    the slots bit for bit, and a masked slot whose id is past the table is
    skipped, not gathered."""
    h, nbr, mask = _case(3, 20, 12, 6, 5, weighted=True)
    nbr[mask == 0] = 10_000  # out of range: must never be read
    th, tn, tm = map(torch.from_numpy, (h, nbr, mask))
    got = tspmm.segment_spmm_emulate(th, tn, tm, mean=True)
    want = torch.zeros(20, 5)
    for i in range(20):
        acc, deg = torch.zeros(5), torch.zeros(())
        for j in range(6):
            if mask[i, j] != 0:
                acc = acc + th[nbr[i, j]] * tm[i, j]
                deg = deg + tm[i, j]
        want[i] = acc / torch.clamp(deg, min=1.0)
    assert torch.equal(got, want)


WALK_CASES = [  # (N, M, K, D); N never a multiple of ROWS (16)
    (37, 50, 1, 8),  # K = 1: one slot of a window
    (45, 60, 33, 20),  # K spans two ballots of a window
    (50, 70, 64, 64),  # the RGCN width; rows 16-31 fill one window's
    # list (1024 entries) far past the ring (STAGES * CHUNK = 256)
    (33, 40, 65, 7),  # two windows, the second of one slot
    (21, 30, 200, 5),  # four windows, the last of 8 slots
]


@pytest.mark.parametrize("mean", [True, False])
@pytest.mark.parametrize("case", WALK_CASES)
def test_emulation_is_bitwise_the_slot_by_slot_walk(case, mean):
    """The block walk changes where each entry is fetched, not the order in
    which a row's entries are added: the same bits as the walk before it.
    Every fifth row has no live slot, every fifth from row 1 has all K
    live, rows 16-31 are all live, and masked slots name rows far past the
    table (never read)."""
    n, m, k, d = case
    h, nbr, mask = _case(6, n, m, k, d, weighted=True)
    rng = np.random.default_rng(7)
    full = np.zeros(n, bool)
    full[1::5] = True
    full[16:32] = k == 64
    mask[full] = (rng.random((int(full.sum()), k)) * 2.0 + 0.5)
    mask[::5] = 0.0
    nbr[mask == 0] = 1 << 30
    th, tn, tm = map(torch.from_numpy, (h, nbr, mask))
    got = tspmm.segment_spmm_emulate(th, tn, tm, mean=mean)
    assert torch.equal(got, _slot_by_slot(th, tn, tm, mean=mean))
    assert (got[::5] == 0).all()
    if k == 64:  # the second block's list spills over the ring
        assert int((tm[16:32] != 0).sum()) > tspmm.STAGES * tspmm.CHUNK


def test_wrapper_takes_the_plain_version_on_cpu():
    h, nbr, mask = map(torch.from_numpy, _case(4, 30, 20, 4, 8))
    before = tspmm.segment_spmm.launches
    got = ops.segment_spmm(h, nbr, mask, mean=True, use_pallas=True)
    assert tspmm.segment_spmm.launches == before
    assert torch.equal(got, ref.segment_spmm(h, nbr, mask, mean=True))
    assert torch.equal(ops.segment_spmm(h, nbr, mask, mean=False),
                       ref.segment_spmm(h, nbr, mask, mean=False))


def test_kernel_args_are_checked():
    h, nbr, mask = map(torch.from_numpy, _case(5, 10, 8, 3, 4))
    tspmm.check_kernel_args(h, nbr, mask)
    with pytest.raises(ValueError, match="int32"):
        tspmm.check_kernel_args(h, nbr.long(), mask)
    with pytest.raises(ValueError, match="float32"):
        tspmm.check_kernel_args(h.double(), nbr, mask)
    with pytest.raises(ValueError, match="contiguous"):
        tspmm.check_kernel_args(h.t().contiguous().t(), nbr, mask)
    with pytest.raises(ValueError, match="one shape"):
        tspmm.check_kernel_args(h, nbr, mask[:, :2])
    with pytest.raises(ValueError, match="several devices"):
        tspmm.segment_spmm(h, nbr, mask.to("meta"))
    with pytest.raises(ValueError, match="no kernel for device meta"):
        tspmm.segment_spmm(h.to("meta"), nbr.to("meta"), mask.to("meta"))
