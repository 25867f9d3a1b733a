"""Semantic Aggregation of the port (``kernels/semantic_attn.py``,
``kernels/ref.py``, ``core/semantics.py``) against the reference: the JAX
oracles, the XLA arm of ``ops.semantic_combine`` and the Pallas kernels in
interpret mode.

Tolerance: atol = rtol = 1e-5 in fp32 (the combine sums P terms in
another order than XLA's einsum; the score mean sums N terms)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import semantics as ref_semantics
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.kernels import semantic_attn as jsem
from repro_torch.core import semantics
from repro_torch.kernels import ops, ref
from repro_torch.kernels import semantic_attn as tsem

TOL = dict(atol=1e-5, rtol=1e-5)


def _case(seed, p, n, d, hs=16):
    rng = np.random.default_rng(seed)
    f32 = np.float32
    return {
        "z": rng.standard_normal((p, n, d)).astype(f32),
        "beta": rng.dirichlet(np.ones(p)).astype(f32),
        "W": (rng.standard_normal((d, hs)) / np.sqrt(d)).astype(f32),
        "b": (rng.standard_normal(hs) * 0.1).astype(f32),
        "q": (rng.standard_normal(hs) / np.sqrt(hs)).astype(f32),
        "mask": (rng.random(n) < 0.8).astype(f32),
    }


def _t(c, *keys):
    return [torch.from_numpy(c[k].copy()) for k in keys]


def _j(c, *keys):
    return [jnp.asarray(c[k]) for k in keys]


@pytest.mark.parametrize("p,n,d", [(2, 300, 64), (3, 77, 16), (1, 10, 8)])
def test_plain_combine_matches_xla_arm_and_pallas(p, n, d):
    c = _case(p * 100 + n, p, n, d)
    z, beta = _t(c, "z", "beta")
    got = ref.semantic_combine(z, beta).numpy()
    jz, jbeta = _j(c, "z", "beta")
    np.testing.assert_allclose(got, np.asarray(
        jops.semantic_combine(jz, jbeta, use_pallas=False)), **TOL)
    np.testing.assert_allclose(got, np.asarray(
        jsem.semantic_combine(jz, jbeta, block_n=128, interpret=True)),
        **TOL)


def test_plain_combine_sums_metapaths_in_order():
    """The plain version is the kernel's arithmetic: a left fold over p of
    separately rounded products — bitwise, not only within tolerance."""
    c = _case(7, 3, 50, 8)
    z, beta = _t(c, "z", "beta")
    want = (beta[0] * z[0] + beta[1] * z[1]) + beta[2] * z[2]
    assert torch.equal(ref.semantic_combine(z, beta), want)


@pytest.mark.parametrize("p,n,d", [(2, 300, 64), (3, 77, 16)])
def test_plain_semantic_attention_matches_jax(p, n, d):
    c = _case(p + n, p, n, d)
    z, w, b, q = _t(c, "z", "W", "b", "q")
    jz, jw, jb, jq = _j(c, "z", "W", "b", "q")
    want = np.asarray(jref.semantic_attention(jz, jw, jb, jq))
    np.testing.assert_allclose(ref.semantic_attention(z, w, b, q).numpy(),
                               want, **TOL)
    np.testing.assert_allclose(np.asarray(jsem.semantic_attention(
        jz, jw, jb, jq, block_n=128, interpret=True)), want, **TOL)


@pytest.mark.parametrize("masked", [False, True])
def test_core_semantic_attention_matches_jax(masked):
    c = _case(11, 2, 120, 32)
    z, w, b, q, mask = _t(c, "z", "W", "b", "q", "mask")
    jz, jw, jb, jq, jmask = _j(c, "z", "W", "b", "q", "mask")
    got = semantics.semantic_attention({"W": w, "b": b, "q": q}, z,
                                       mask if masked else None)
    want = ref_semantics.semantic_attention({"W": jw, "b": jb, "q": jq}, jz,
                                            jmask if masked else None)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    got_l = semantics.semantic_attention_list(
        {"W": w, "b": b, "q": q}, list(z), mask if masked else None)
    np.testing.assert_allclose(got_l.numpy(), np.asarray(want), **TOL)


def test_init_semantic_attention_shapes_and_scales():
    p = semantics.init_semantic_attention(torch.Generator().manual_seed(0),
                                          64, 128)
    assert p["W"].shape == (64, 128) and p["q"].shape == (128,)
    assert torch.equal(p["b"], torch.zeros(128))
    assert abs(float(p["W"].std()) - 1 / 8) < 0.01  # 1/sqrt(d_in)


def test_wrapper_on_cpu_runs_plain_and_counts_nothing():
    c = _case(12, 2, 40, 8)
    z, beta = _t(c, "z", "beta")
    ops.reset_launch_counts()
    got = ops.semantic_combine(z, beta, use_pallas=True)
    assert torch.equal(got, tsem.semantic_combine_plain(z, beta))
    assert torch.equal(got, ops.semantic_combine(z, beta, use_pallas=False))
    assert ops.launch_counts()["semantic_combine"] == 0


@pytest.mark.parametrize("z,beta,match", [
    (torch.empty((2, 5, 4), device="meta"),
     torch.empty((3,), device="meta"), "beta \\[P\\]"),
    (torch.empty((2, 5, 4), dtype=torch.float64, device="meta"),
     torch.empty((2,), dtype=torch.float64, device="meta"), "float32"),
    (torch.empty((2, 4, 5), device="meta").transpose(1, 2),
     torch.empty((2,), device="meta"), "contiguous"),
])
def test_kernel_args_reject_what_the_kernel_does_not_take(z, beta, match):
    with pytest.raises(ValueError, match=match):
        tsem.check_kernel_args(z, beta)


def test_wrapper_rejects_split_and_unknown_devices():
    with pytest.raises(ValueError, match="beta on"):
        tsem.semantic_combine(torch.zeros(2, 3, 4),
                              torch.zeros(2, device="meta"))
    with pytest.raises(ValueError, match="no kernel"):
        tsem.semantic_combine(torch.zeros(2, 3, 4, device="meta"),
                              torch.zeros(2, device="meta"))
