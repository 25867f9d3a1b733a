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


# ---------------------------------------------------------------------------
# SA pass 1: semantic_scores, and both passes through ops.semantic_attention
# ---------------------------------------------------------------------------


def _jax_scores(c):
    jz, jw, jb, jq = _j(c, "z", "W", "b", "q")
    return np.asarray(jnp.mean(jnp.tanh(jz @ jw + jb) @ jq, axis=1))


@pytest.mark.parametrize("p,n,d,block_n,budget", [
    (2, 300, 64, 128, None),  # resident, N not a multiple of block_n
    (3, 77, 16, 32, None),  # resident, a ragged last tile
    (2, 300, 64, 128, 4096),  # streaming: z over the VMEM budget
    (1, 45, 8, 16, 256),  # streaming, one metapath, tail-aligned chunk
])
def test_plain_and_emulated_scores_match_jax_and_pallas(p, n, d, block_n,
                                                        budget):
    c = _case(p * 1000 + n, p, n, d)
    z, w, b, q = _t(c, "z", "W", "b", "q")
    jz, jw, jb, jq = _j(c, "z", "W", "b", "q")
    kw = {} if budget is None else {"vmem_budget": budget}
    pallas = np.asarray(jsem.semantic_scores(jz, jw, jb, jq,
                                             block_n=block_n, interpret=True,
                                             **kw))
    want = _jax_scores(c)
    np.testing.assert_allclose(pallas, want, **TOL)
    for got in (ref.semantic_scores(z, w, b, q),
                tsem.semantic_scores_emulate(z, w, b, q),
                tsem.semantic_scores(z, w, b, q)):
        assert got.shape == (p,)
        np.testing.assert_allclose(got.numpy(), want, **TOL)
        np.testing.assert_allclose(got.numpy(), pallas, **TOL)


def _kernel_order_sum(score, n, tile):
    """The scores kernel's sums written out one add at a time: row scores
    ``[P, N]`` -> ``[P]``.  Tiles of ``tile`` rows summed in row order,
    lane ``l`` of 32 adds tiles ``l, l + 32, ...`` in order, then the xor
    butterfly over the lanes (lane 0's view), then / N."""
    n_tiles = -(-n // tile)
    out = []
    for row in score:
        partial = []
        for t in range(n_tiles):
            v = torch.zeros((), dtype=score.dtype)
            for r in range(t * tile, min(n, (t + 1) * tile)):
                v = v + row[r]
            partial.append(v)
        lanes = []
        for lane in range(32):
            v = torch.zeros((), dtype=score.dtype)
            for t in range(lane, n_tiles, 32):
                v = v + partial[t]
            lanes.append(v)
        while len(lanes) > 1:
            half = len(lanes) // 2
            lanes = [lanes[i] + lanes[i + half] for i in range(half)]
        out.append(lanes[0] / n)
    return torch.stack(out)


@pytest.mark.parametrize("tile", [64, 72, 128])
def test_emulated_scores_sum_blocks_in_order(tile):
    """The emulation sums in the kernel's order, bitwise: rows within a
    tile, tiles lane-strided, the lanes' butterfly, at the smallest tile,
    the main path's (72 rows) and the largest.  N = 1, N = 2 tiles + 1 row,
    and N of 33 tiles + 1 row (more tiles than lanes: lane 0 adds two
    tiles), each also held against JAX."""
    for n in (1, 2 * tile + 1, 33 * tile + 1):
        c = _case(n, 2, n, 8)
        z, w, b, q = _t(c, "z", "W", "b", "q")
        got = tsem.semantic_scores_emulate(z, w, b, q, tile)
        score = (torch.tanh(z @ w + b) * q).sum(-1)
        assert torch.equal(got, _kernel_order_sum(score, n, tile))
        np.testing.assert_allclose(got.numpy(), _jax_scores(c), **TOL)


@pytest.mark.parametrize("p,n,d,hs,block_n,budget", [
    (2, 130, 16, 33, 64, None),  # resident; N and Hs off the tile and warp
    (2, 130, 16, 33, 32, 2048),  # streaming, the same shapes
    (1, 65, 8, 7, 32, None),  # one metapath, a one-row last tile
    (1, 65, 8, 7, 16, 256),  # streaming, one metapath
    (3, 2113, 12, 20, 256, None),  # 34 tiles: lanes 0 and 1 add two
    (3, 2113, 12, 20, 512, 8192),  # streaming, the same shapes
])
def test_emulated_scores_match_jax_at_edge_shapes(p, n, d, hs, block_n,
                                                  budget):
    """The emulation against the JAX ``semantic_scores`` (Pallas in
    interpret mode, resident and streaming bodies) where N is not a
    multiple of the kernel's tile, Hs not a multiple of 32, and P = 1."""
    c = _case(p * 10000 + n + hs, p, n, d, hs)
    z, w, b, q = _t(c, "z", "W", "b", "q")
    jz, jw, jb, jq = _j(c, "z", "W", "b", "q")
    kw = {} if budget is None else {"vmem_budget": budget}
    pallas = np.asarray(jsem.semantic_scores(jz, jw, jb, jq,
                                             block_n=block_n, interpret=True,
                                             **kw))
    np.testing.assert_allclose(pallas, _jax_scores(c), **TOL)
    for tile in (64, 72, 128):
        got = tsem.semantic_scores_emulate(z, w, b, q, tile)
        assert got.shape == (p,)
        np.testing.assert_allclose(got.numpy(), pallas, **TOL)


def test_scores_smem_limit_takes_every_shape_the_layout_fits():
    """``check_scores_args`` refuses exactly where the kernel's shared
    memory at its smallest tile (W padded to multiples of 4, the z ring, a
    tile's row scores) passes the limit: at Hs = 256 the widest D is
    208."""
    def meta(d, hs):
        return _scores_meta(z=torch.empty((2, 10, d), device="meta"),
                            w=torch.empty((d, hs), device="meta"),
                            b=torch.empty((hs,), device="meta"),
                            q=torch.empty((hs,), device="meta"))

    assert tsem.smem_bytes(208, 256) <= tsem.SMEM_LIMIT
    assert tsem.smem_bytes(209, 256) > tsem.SMEM_LIMIT
    tsem.check_scores_args(**meta(208, 256))
    with pytest.raises(ValueError, match="shared memory"):
        tsem.check_scores_args(**meta(209, 256))


@pytest.mark.parametrize("use_pallas", [False, True])
@pytest.mark.parametrize("p,n,d", [(2, 300, 64), (3, 77, 16)])
def test_ops_semantic_attention_matches_jax_ops(p, n, d, use_pallas):
    c = _case(p + 7 * n, p, n, d)
    z, w, b, q = _t(c, "z", "W", "b", "q")
    jz, jw, jb, jq = _j(c, "z", "W", "b", "q")
    want = np.asarray(jops.semantic_attention(
        jz, jw, jb, jq, use_pallas=use_pallas, interpret=use_pallas))
    ops.reset_launch_counts()
    got = ops.semantic_attention(z, w, b, q, use_pallas=use_pallas)
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    assert torch.equal(got, ref.semantic_attention(z, w, b, q))
    assert set(ops.launch_counts().values()) == {0}  # CPU: plain versions


def _scores_meta(**over):
    """Meta tensors at MAGNN/imdb's SA shapes."""
    a = dict(z=torch.empty((2, 4278, 64), device="meta"),
             w=torch.empty((64, 128), device="meta"),
             b=torch.empty((128,), device="meta"),
             q=torch.empty((128,), device="meta"))
    a.update(over)
    return a


def test_scores_args_accept_the_main_path_shapes():
    tsem.check_scores_args(**_scores_meta())


@pytest.mark.parametrize("over,match", [
    (dict(w=torch.empty((32, 128), device="meta")), "W \\[D, Hs\\]"),
    (dict(q=torch.empty((127,), device="meta")), "q \\[Hs\\]"),
    (dict(z=torch.empty((2, 0, 64), device="meta")), "empty"),
    (dict(w=torch.empty((64, 257), device="meta"),
          b=torch.empty((257,), device="meta"),
          q=torch.empty((257,), device="meta")), "Hs <= 256"),
    (dict(z=torch.empty((2, 4278, 256), device="meta"),
          w=torch.empty((256, 256), device="meta"),
          b=torch.empty((256,), device="meta"),
          q=torch.empty((256,), device="meta")), "shared memory"),
    (dict(z=torch.empty((2, 4278, 64), dtype=torch.float64, device="meta")),
     "float32"),
    (dict(z=torch.empty((2, 64, 4278), device="meta").transpose(1, 2)),
     "contiguous"),
])
def test_scores_args_reject_what_the_kernel_does_not_take(over, match):
    with pytest.raises(ValueError, match=match):
        tsem.check_scores_args(**_scores_meta(**over))


def test_scores_wrapper_rejects_mixed_and_unknown_devices():
    a = _scores_meta()
    cpu = {k: torch.zeros(v.shape) for k, v in a.items()}
    with pytest.raises(ValueError, match="several devices"):
        tsem.semantic_scores(cpu["z"], a["w"], cpu["b"], cpu["q"])
    with pytest.raises(ValueError, match="no kernel"):
        tsem.semantic_scores(**a)
