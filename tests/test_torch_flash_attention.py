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
                                        (65, 3, 1, 8)])
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
