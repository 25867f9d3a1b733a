"""The port's prefill attention (``kernels/flash_attention.py``,
``kernels/ref.py::mha_attention``) against the reference: the JAX oracle
and the Pallas kernel in interpret mode, over the reference's own grid
(``tests/test_kernels.py``: causal / non-causal / window 40, G in {1, 2,
3}, fp32 and bf16), plus lengths the Pallas kernel cannot take.

Tolerances are the reference's kernel-test ones: atol = rtol = 2e-4 in
fp32 (online softmax over tiles against one softmax, sums in another
order) and 2e-2 in bf16 (the oracle rounds the scores and P to bf16)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro.kernels.flash_attention import flash_attention as pallas_flash
from repro_torch.kernels import flash_attention as tflash
from repro_torch.kernels import ops, ref

TOL = {"float32": dict(atol=2e-4, rtol=2e-4),
       "bfloat16": dict(atol=2e-2, rtol=2e-2)}


def _qkv(seed, b, s, h, kvh, dh, dtype="float32"):
    rng = np.random.default_rng(seed)
    arrs = [(rng.standard_normal(shape) * 0.5).astype(np.float32)
            for shape in ((b, s, h, dh), (b, s, kvh, dh), (b, s, kvh, dh))]
    j = [jnp.asarray(a, getattr(jnp, dtype)) for a in arrs]
    t = [torch.from_numpy(a).to(getattr(torch, dtype)) for a in arrs]
    return j, t


def _np(x):
    return np.asarray(x.float() if torch.is_tensor(x) else x, np.float32)


@pytest.mark.parametrize("s,h,kvh,dh,bq,bk", [(128, 4, 2, 32, 32, 32),
                                              (256, 8, 8, 16, 64, 128),
                                              (128, 6, 2, 64, 128, 64)])
@pytest.mark.parametrize("causal,window", [(True, 0), (False, 0), (True, 40)])
def test_plain_and_emulation_match_pallas(s, h, kvh, dh, bq, bk, causal,
                                          window):
    (jq, jk, jv), (q, k, v) = _qkv(s + h + dh, 2, s, h, kvh, dh)
    want = _np(pallas_flash(jq, jk, jv, causal=causal, window=window,
                            block_q=bq, block_k=bk, interpret=True))
    got = ref.mha_attention(q, k, v, causal=causal, window=window)
    np.testing.assert_allclose(_np(got), want, **TOL["float32"])
    emu = tflash.flash_attention_emulate(q, k, v, causal=causal,
                                         window=window)
    np.testing.assert_allclose(_np(emu), want, **TOL["float32"])
    # the wrapper on a CPU tensor is the plain version
    np.testing.assert_array_equal(
        _np(ops.flash_attention(q, k, v, causal, window, use_pallas=True)),
        _np(got))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_dtypes_match_pallas(dtype):
    (jq, jk, jv), (q, k, v) = _qkv(7, 1, 128, 4, 2, 32, dtype)
    want = _np(pallas_flash(jq, jk, jv, block_q=64, block_k=64,
                            interpret=True))
    got = ref.mha_attention(q, k, v)
    emu = tflash.flash_attention_emulate(q, k, v)
    assert got.dtype == emu.dtype == q.dtype
    np.testing.assert_allclose(_np(got), want, **TOL[dtype])
    np.testing.assert_allclose(_np(emu), want, **TOL[dtype])


@pytest.mark.parametrize("s,h,kvh,dh", [(100, 4, 4, 20), (130, 6, 2, 16),
                                        (65, 3, 1, 8), (65, 2, 1, 128),
                                        (129, 4, 2, 120)])
@pytest.mark.parametrize("causal,window", [(True, 0), (False, 0), (True, 40),
                                           (False, 40)])
def test_tail_lengths_match_the_oracle(s, h, kvh, dh, causal, window):
    """Lengths that are not a multiple of a tile: the emulation masks the
    tail, the JAX oracle takes any length."""
    (jq, jk, jv), (q, k, v) = _qkv(s * h, 2, s, h, kvh, dh)
    want = _np(jref.mha_attention(jq, jk, jv, causal=causal, window=window))
    np.testing.assert_allclose(
        _np(ref.mha_attention(q, k, v, causal=causal, window=window)), want,
        **TOL["float32"])
    emu = tflash.flash_attention_emulate(q, k, v, causal=causal,
                                         window=window)
    assert torch.isfinite(emu).all()
    np.testing.assert_allclose(_np(emu), want, **TOL["float32"])


@pytest.mark.parametrize("s,causal,window", [(256, True, 0), (200, True, 40),
                                             (256, False, 70),
                                             (130, False, 0)])
def test_fully_masked_tiles_are_skipped_exactly(monkeypatch, s, causal,
                                                window):
    """``kv_tiles`` (the kernel's loop bounds, which the emulation walks)
    names exactly the kv tiles holding a live pair of the query tile, and
    skipping the others gives the same bits as visiting every tile."""
    _, (q, k, v) = _qkv(s, 1, s, 4, 2, 16)
    bq, bk = tflash.BLOCK_Q, tflash.BLOCK_K
    n_q, n_k = -(-s // bq), -(-s // bk)
    skipped = 0
    for qt in range(n_q):
        rows = np.arange(qt * bq, min(qt * bq + bq, s))
        live_tiles = []
        for kt in range(n_k):
            cols = np.arange(kt * bk, min(kt * bk + bk, s))
            live = np.ones((len(rows), len(cols)), bool)
            if causal:
                live &= rows[:, None] >= cols[None, :]
            if window:
                live &= rows[:, None] - cols[None, :] < window
            if live.any():
                live_tiles.append(kt)
        assert list(tflash.kv_tiles(qt * bq, s, causal, window)) == \
            live_tiles
        skipped += n_k - len(live_tiles)
    assert skipped > 0 or not (causal or window)
    got = tflash.flash_attention_emulate(q, k, v, causal, window)
    monkeypatch.setattr(tflash, "kv_tiles",
                        lambda q0, s_, c, w: range(n_k))  # every tile
    every = tflash.flash_attention_emulate(q, k, v, causal, window)
    assert torch.equal(got, every)
    assert torch.isfinite(got).all()


def test_split_hi_lo_carries_sixteen_bits():
    """The bf16 kernel's P for P·V: ``hi + lo`` is fp32 ``p`` to within
    2^-16 relative over the range softmax weights take, ``hi`` alone only
    to 2^-9, and ``p = 0`` (a masked key) splits to exactly 0 + 0."""
    rng = np.random.default_rng(16)
    x = np.concatenate([[0.0], rng.uniform(0.0, 30.0, 4095)])
    p = torch.from_numpy(np.exp(-x).astype(np.float32))
    hi, lo = tflash.split_hi_lo(p)
    assert hi.dtype == lo.dtype == torch.float32
    assert torch.equal(hi, hi.to(torch.bfloat16).float())
    assert torch.equal(lo, lo.to(torch.bfloat16).float())
    rel = ((hi + lo) - p).abs() / p
    assert rel.max() <= 2.0 ** -16
    assert ((hi - p).abs() / p).max() > 2.0 ** -16  # hi alone is coarser
    z_hi, z_lo = tflash.split_hi_lo(torch.zeros(3))
    assert torch.equal(z_hi, torch.zeros(3))
    assert torch.equal(z_lo, torch.zeros(3))


@pytest.mark.parametrize("s,h,kvh,dh", [(129, 4, 2, 128), (65, 2, 1, 120),
                                        (100, 4, 4, 20)])
@pytest.mark.parametrize("causal,window", [(True, 0), (False, 0), (True, 40)])
def test_bf16_arm_matches_the_oracle_and_the_fp32_result(s, h, kvh, dh,
                                                         causal, window):
    """The tensor-core kernel's numbers (scale after the dot, in the
    exponent; P as bf16 hi + lo) on bf16 inputs: within the reference's
    bf16 tolerance of the JAX
    oracle, and within a bf16 output's rounding (atol 1e-3, rtol 8e-3, the
    chip check's) of the fp32 computation on the same values."""
    (jq, jk, jv), (q, k, v) = _qkv(s * dh, 2, s, h, kvh, dh, "bfloat16")
    emu = tflash.flash_attention_emulate(q, k, v, causal=causal,
                                         window=window)
    assert emu.dtype == torch.bfloat16 and torch.isfinite(emu).all()
    want = _np(jref.mha_attention(jq, jk, jv, causal=causal, window=window))
    np.testing.assert_allclose(_np(emu), want, **TOL["bfloat16"])
    exact = ref.mha_attention(q.float(), k.float(), v.float(), causal=causal,
                              window=window).to(torch.bfloat16)
    np.testing.assert_allclose(_np(emu), _np(exact), atol=1e-3, rtol=8e-3)


@pytest.mark.parametrize("s,causal,window", [(256, True, 0), (200, True, 40),
                                             (130, False, 70)])
def test_fully_masked_tiles_are_skipped_exactly_bf16(monkeypatch, s, causal,
                                                     window):
    """The same for the bf16 kernel's numbers: a skipped tile and a visited
    fully masked tile give the same bits (``alpha = 2^0 = 1``, ``p = 0``
    splits to 0 + 0)."""
    _, (q, k, v) = _qkv(s, 1, s, 4, 2, 16, "bfloat16")
    got = tflash.flash_attention_emulate(q, k, v, causal, window)
    n_k = -(-s // tflash.BLOCK_K)
    monkeypatch.setattr(tflash, "kv_tiles",
                        lambda q0, s_, c, w: range(n_k))  # every tile
    assert torch.equal(got, tflash.flash_attention_emulate(q, k, v, causal,
                                                           window))


def test_kernel_constraints_raise_on_cpu_checks():
    """The launcher's argument checks (run before any build)."""
    q = torch.zeros((1, 8, 2, 136))
    with pytest.raises(ValueError, match="head dim"):
        tflash.check_kernel_args(q, q, q)
    q = torch.zeros((1, 8, 3, 16))
    k = torch.zeros((1, 8, 2, 16))
    with pytest.raises(ValueError, match="multiple"):
        tflash.check_kernel_args(q, k, k)
    with pytest.raises(ValueError, match="window"):
        tflash.check_kernel_args(k, k, k, window=-1)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        tflash.check_kernel_args(k.half(), k.half(), k.half())
