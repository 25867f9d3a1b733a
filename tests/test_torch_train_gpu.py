"""The port's LM training path on the card, held against the same
computation on the CPU at a small size.  Every test needs a CUDA device
and skips without one.  The file imports no jax:

    PYTHONPATH=src python -m pytest --noconftest -p no:cacheprovider \\
        -m gpu tests/test_torch_train_gpu.py

Tolerances: the embedding's gradient goes through the ``segment_sum``
kernel, which adds each id's rows in token order as the CPU's plain
version does, so it is held bitwise against the CPU.  Two train steps
(AdamW and Adafactor, 1 and 2 microbatches) on the card against the same
steps on the CPU: loss, gradient norm and optimizer state at atol = rtol =
1e-4 (the matmuls and the attention's long sums run in other orders on the
two devices), parameters at an atol of the larger step's learning rate
(AdamW's first step is about ``lr * sign(g)``).  On the card alone: two
runs of the same steps, the three remat modes, and a checkpoint round trip
are bitwise.
"""
import numpy as np
import pytest
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops
from repro_torch.nn import transformer as ttf
from repro_torch.train import checkpoint as tckpt
from repro_torch import tree
from repro_torch.train.optimizer import build_optimizer, lr_schedule
from repro_torch.train.train_step import (init_train_state, make_train_step,
                                          value_and_grad)

pytestmark = pytest.mark.gpu
TOL_CPU = dict(atol=1e-4, rtol=1e-4)
# small, with 1280 tokens a row: the chunked attention arm (above 1024)
CFG = ModelConfig(name="small", family="dense", n_layers=2, d_model=64,
                  n_heads=4, n_kv_heads=2, d_ff=128, vocab=300,
                  tie_embeddings=True, dtype="float32",
                  param_dtype="float32", attn_chunk=256, remat="full")
SEQ = 1280
TOTAL_STEPS = 10  # the run the optimizer schedules


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _batch(b, seed, device):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, CFG.vocab, (b, SEQ)).astype(np.int32)
    labels = np.roll(toks, -1, axis=1)
    labels[:, -2:] = -1
    return {"tokens": torch.as_tensor(toks, device=device),
            "labels": torch.as_tensor(labels, device=device)}


def _state(cfg):
    """Step 0 of ``cfg`` with weights drawn on the CPU from seed 0."""
    return init_train_state(torch.Generator().manual_seed(0), cfg,
                            build_optimizer(cfg, total_steps=TOTAL_STEPS))


def _to(state, device):
    return tree.map(lambda x: x.to(device), state)


def _run(cfg, state, device, steps, n_mb=1):
    opt = build_optimizer(cfg, total_steps=TOTAL_STEPS)
    step_fn = make_train_step(cfg, opt, n_microbatches=n_mb)
    state = _to(state, device)
    metrics = []
    for i in range(steps):
        state, m = step_fn(state, _batch(4, 40 + i, device))
        metrics.append(m)
    return state, metrics


def _equal(a, b):
    return all(torch.equal(x, y) for x, y in zip(tree.leaves(a),
                                                   tree.leaves(b)))


@pytest.mark.parametrize("n_ids,vocab,dtype", [
    (4096, 49152, torch.float32),  # 2 x 2048 tokens of smollm's vocab
    (2000, 50, torch.float32),  # ids repeated over 256 times: long segments
    (777, 300, torch.bfloat16),
])
def test_embedding_gradient_bitwise_the_cpu(cuda, n_ids, vocab, dtype):
    rng = np.random.default_rng(n_ids)
    table = torch.as_tensor(rng.standard_normal((vocab, 96)),
                            dtype=dtype)
    ids = torch.as_tensor(rng.integers(0, vocab, n_ids).astype(np.int32))
    dx = torch.as_tensor(rng.standard_normal((n_ids, 96)), dtype=dtype)

    def grad(device):
        t = table.to(device).requires_grad_()
        out = ttf._EmbedGather.apply(t, ids.to(device))
        (g,) = torch.autograd.grad(out, t, grad_outputs=dx.to(device))
        return g

    ops.reset_launch_counts()
    got = grad(cuda)
    torch.cuda.synchronize()
    assert ops.launch_counts()["segment_sum"] == 1
    assert got.dtype == dtype
    assert torch.equal(got.cpu(), grad("cpu"))


@pytest.mark.parametrize("optimizer", ["adamw", "adafactor"])
@pytest.mark.parametrize("n_mb", [1, 2])
def test_train_step_card_against_cpu(cuda, n_mb, optimizer):
    cfg = CFG.replace(optimizer=optimizer)
    state = _state(cfg)
    ops.reset_launch_counts()
    got, gm = _run(cfg, state, cuda, 2, n_mb)
    torch.cuda.synchronize()
    assert ops.launch_counts()["segment_sum"] == 2 * n_mb
    want, wm = _run(cfg, state, "cpu", 2, n_mb)
    for a, b in zip(gm, wm):
        for k in ("loss", "grad_norm"):
            assert a[k].device.type == "cuda" and a[k].dim() == 0
            torch.testing.assert_close(a[k].cpu(), b[k], **TOL_CPU)
    lr = float(lr_schedule(TOTAL_STEPS)(1))  # step 1's, the larger
    for a, b in zip(tree.leaves(got.params), tree.leaves(want.params)):
        torch.testing.assert_close(a.cpu(), b, atol=lr, rtol=0)
    for a, b in zip(tree.leaves(got.opt), tree.leaves(want.opt)):
        torch.testing.assert_close(a.cpu(), b, **TOL_CPU)


def test_same_steps_give_the_same_bits(cuda):
    state = _state(CFG)
    a, am = _run(CFG, state, cuda, 3, 2)
    b, bm = _run(CFG, state, cuda, 3, 2)
    assert all(torch.equal(x["loss"], y["loss"]) for x, y in zip(am, bm))
    assert _equal(a, b)


def test_remat_modes_bitwise_on_the_card(cuda):
    state = _state(CFG)
    params = _to(state.params, cuda)
    batch = _batch(2, 7, cuda)
    runs = [value_and_grad(
        lambda p, batch: ttf.lm_loss(p, CFG.replace(remat=r), batch),
        params, batch) for r in ("none", "full", "dots")]
    for loss, grads in runs[1:]:
        assert torch.equal(loss, runs[0][0])
        assert _equal(grads, runs[0][1])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_checkpoint_round_trip_on_the_card(cuda, tmp_path, dtype):
    cfg = CFG.replace(dtype=dtype, param_dtype=dtype)
    state = _state(cfg)
    state, _ = _run(cfg, state, cuda, 1)
    d = str(tmp_path / "ck")
    tckpt.save(state, d, step=1)
    got = tckpt.restore(d, state, device=cuda)
    assert all(x.device.type == "cuda" for x in tree.leaves(got))
    assert all(x.dtype == y.dtype for x, y in zip(tree.leaves(got),
                                                  tree.leaves(state)))
    assert _equal(got, state)
