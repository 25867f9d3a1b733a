"""The port's decode attention (``kernels/decode_attention.py``,
``kernels/ref.py::decode_attention``) against the reference: the JAX
oracle and the Pallas kernel in interpret mode over the reference's grid
(``tests/test_kernels.py``), G in {1, 2, 3}, fp32 and bf16, plus cache
lengths the Pallas kernel cannot take and ``kv_len`` at 1 and at ``S``.

Tolerances are the reference's: atol = rtol = 2e-4 in fp32 (split partials
rescaled and summed against one softmax), 2e-2 in bf16 (the oracle rounds
the scores and P to bf16)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro.kernels.decode_attention import decode_attention as pallas_dec
from repro_torch.kernels import decode_attention as tdec
from repro_torch.kernels import ops, ref

TOL = {"float32": dict(atol=2e-4, rtol=2e-4),
       "bfloat16": dict(atol=2e-2, rtol=2e-2)}


def _case(seed, b, s, h, kvh, dh, lens=None, dtype="float32"):
    rng = np.random.default_rng(seed)
    arrs = [(rng.standard_normal(shape) * 0.5).astype(np.float32)
            for shape in ((b, h, dh), (b, s, kvh, dh), (b, s, kvh, dh))]
    if lens is None:
        lens = rng.integers(1, s + 1, (b,))
    lens = np.asarray(lens, np.int32)
    j = [jnp.asarray(a, getattr(jnp, dtype)) for a in arrs]
    t = [torch.from_numpy(a).to(getattr(torch, dtype)) for a in arrs]
    return j + [jnp.asarray(lens)], t + [torch.from_numpy(lens)]


def _np(x):
    return np.asarray(x.float() if torch.is_tensor(x) else x, np.float32)


@pytest.mark.parametrize("b,s,h,kvh,dh,bk", [(2, 128, 4, 2, 32, 32),
                                             (3, 256, 8, 8, 16, 128),
                                             (2, 128, 6, 2, 24, 64)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_and_emulation_match_pallas(b, s, h, kvh, dh, bk, dtype):
    (jq, jk, jv, jl), (q, k, v, kv_len) = _case(b * s + h, b, s, h, kvh, dh,
                                                dtype=dtype)
    want = _np(pallas_dec(jq, jk, jv, jl, block_k=bk, interpret=True))
    got = ref.decode_attention(q, k, v, kv_len)
    emu = tdec.decode_attention_emulate(q, k, v, kv_len)
    assert got.dtype == emu.dtype == q.dtype
    np.testing.assert_allclose(_np(got), want, **TOL[dtype])
    np.testing.assert_allclose(_np(emu), want, **TOL[dtype])
    np.testing.assert_array_equal(
        _np(ops.decode_attention(q, k, v, kv_len, use_pallas=True)),
        _np(got))


@pytest.mark.parametrize("b,s,h,kvh,dh,lens", [
    (3, 100, 4, 4, 20, [1, 57, 100]),  # kv_len 1 and S, S not a tile
    (2, 300, 6, 2, 16, [300, 129]),  # three splits, one past a boundary
    (2, 2080, 4, 1, 8, [2049, 2080]),  # the main path's cache length
    (2, 257, 4, 2, 128, [257, 33]),  # one past a split and past a tile
    (1, 520, 8, 2, 120, [520]),  # full splits: the ring wraps twice
    (2, 300, 6, 3, 20, [289, 256]),  # Dh 20, kv_len at a split's end
])
def test_tail_lengths_match_the_oracle(b, s, h, kvh, dh, lens):
    (jq, jk, jv, jl), (q, k, v, kv_len) = _case(s, b, s, h, kvh, dh, lens)
    want = _np(jref.decode_attention(jq, jk, jv, jl))
    np.testing.assert_allclose(_np(ref.decode_attention(q, k, v, kv_len)),
                               want, **TOL["float32"])
    np.testing.assert_allclose(
        _np(tdec.decode_attention_emulate(q, k, v, kv_len)), want,
        **TOL["float32"])


def test_rows_past_kv_len_are_never_read():
    """NaN in every cache row at or past ``kv_len``: the emulation (which
    walks only the live splits and rows, as the kernels do) stays finite
    and gives the same bits."""
    _, (q, k, v, kv_len) = _case(3, 3, 300, 6, 2, 16, [1, 129, 256])
    got = tdec.decode_attention_emulate(q, k, v, kv_len)
    kp, vp = k.clone(), v.clone()
    for i, n in enumerate(kv_len.tolist()):
        kp[i, n:] = float("nan")
        vp[i, n:] = float("nan")
    poisoned = tdec.decode_attention_emulate(q, kp, vp, kv_len)
    assert torch.isfinite(poisoned).all()
    assert torch.equal(poisoned, got)


def test_scalar_kv_len_and_argument_checks():
    _, (q, k, v, _) = _case(4, 2, 64, 4, 2, 8)
    np.testing.assert_allclose(
        _np(tdec.decode_attention_emulate(q, k, v, 40)),
        _np(ref.decode_attention(q, k, v, 40)), **TOL["float32"])
    with pytest.raises(ValueError, match="int32"):
        tdec.check_kernel_args(q, k, v, torch.full((2,), 40))
    with pytest.raises(ValueError, match="head dim"):
        big = torch.zeros((2, 8, 4, 129))
        tdec.check_kernel_args(big[:, 0], big, big,
                               torch.ones(2, dtype=torch.int32))
