"""The port's MoE, SSM and hybrid LM families on the card, held against
the same computation on the CPU at a small width.  Every test needs a CUDA
device and skips without one.  The file imports no jax:

    PYTHONPATH=src python -m pytest --noconftest -p no:cacheprovider \\
        -m gpu tests/test_torch_lm_families_gpu.py

Tolerances: TF32 off; the card against the CPU at atol = rtol = 1e-4 (the
matmuls and the SSD's sums run in other orders on the two devices), a
train step's parameters at an atol of its learning rate (AdamW's first
step is about ``lr * sign(g)``).  The MoE's routing (which choices are
kept) equal on both devices; the kernel arm (``use_pallas``) against the
plain arm on one card at 1e-4 with exact launches; two card runs of a
train step bitwise (no float atomic on the path: ROADMAP check (d)).
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.configs.registry import get_reduced
from repro_torch.kernels import ops
from repro_torch.nn import moe as tmoe
from repro_torch.nn import ssm as tssm
from repro_torch.nn import transformer as ttf
from repro_torch import tree
from repro_torch.train.optimizer import build_optimizer, lr_schedule
from repro_torch.train.train_step import init_train_state, make_train_step

pytestmark = pytest.mark.gpu
TOL_CPU = dict(atol=1e-4, rtol=1e-4)
PHI, ZAMBA = "phi3.5-moe-42b-a6.6b", "zamba2-1.2b"
TOTAL_STEPS = 10


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _to(x, device):
    return tree.map(lambda t: t.to(device), x)


def _normal(seed, shape, scale=1.0):
    rng = np.random.default_rng(seed)
    return torch.as_tensor((rng.standard_normal(shape) * scale).astype(
        np.float32))


@pytest.mark.parametrize("cf", [2.0, 0.5])  # 0.5: choices dropped
def test_moe_block_forward_backward_card_against_cpu(cuda, cf):
    moe = dataclasses.replace(get_reduced(PHI).moe, capacity_factor=cf)
    params = tmoe.init_moe(torch.Generator().manual_seed(0), 64, moe, 2,
                           torch.float32)
    x, w = _normal(1, (3, 200, 64)), _normal(2, (3, 200, 64))

    def run(device):
        flat = [t.to(device).requires_grad_() for t in tree.leaves(params)]
        p = tree.unflatten(params, flat)
        xd = x.to(device).requires_grad_()
        out, aux = tmoe.moe_block(p, xd, moe)
        grads = torch.autograd.grad((out * w.to(device)).sum() + aux,
                                    [xd] + flat)
        keep = tmoe.route(p["router"].detach(), xd.detach(), moe,
                          tmoe._capacity(200, moe)).keep
        return [out, aux, *grads], keep

    got, keep = run(cuda)
    again, _ = run(cuda)
    want, keep_cpu = run("cpu")
    assert torch.equal(keep.cpu(), keep_cpu)
    assert bool((~keep_cpu).any()) == (cf < 1.0)
    for a, b in zip(got, want):
        torch.testing.assert_close(a.cpu(), b, **TOL_CPU)
    assert all(torch.equal(a, b) for a, b in zip(got, again))


def test_mamba2_block_prefill_and_decode_card_against_cpu(cuda):
    cfg = get_reduced(ZAMBA)
    params = tssm.init_mamba2(torch.Generator().manual_seed(0), 64, cfg.ssm,
                              2, torch.float32)
    x = _normal(3, (2, 68, 64), 0.5)

    def run(device):
        p = _to(params, device)
        outs, c = [], None
        out, c = tssm.mamba2_block(p, cfg, x[:, :64].to(device),
                                   return_state=True)
        outs.append(out)
        for t in range(64, 68):
            out, c = tssm.mamba2_block(p, cfg, x[:, t:t + 1].to(device),
                                       cache=c)
            outs.append(out)
        return outs + list(c)

    for a, b in zip(run(cuda), run("cpu")):
        torch.testing.assert_close(a.cpu(), b, **TOL_CPU)


@pytest.mark.parametrize("name,flash,decode", [(PHI, 2, 2), (ZAMBA, 2, 2)])
def test_kernel_arm_against_plain_arm_on_the_card(cuda, name, flash, decode):
    """Prefill 2 x 32 then 4 teacher-forced decode steps: the
    ``flash_attention`` / ``decode_attention`` arm against the plain arm,
    on the same weights; the launches exact (zamba2's shared block twice a
    pass)."""
    cfg = get_reduced(name)
    params = ttf.init_lm_params(torch.Generator(device=cuda).manual_seed(0),
                                cfg)
    toks = torch.as_tensor(np.random.default_rng(4).integers(
        0, cfg.vocab, (2, 36)), device=cuda)

    def run(c):
        with torch.inference_mode():
            lg, pf = ttf.lm_prefill(params, c, toks[:, :32])
            caches = ttf.graft_prefill_caches(
                c, ttf.init_kv_caches(c, 2, 36, cuda), pf, 32)
            steps = [lg]
            for t in range(32, 36):
                lg, caches = ttf.lm_decode_step(params, c, toks[:, t:t + 1],
                                                caches, t)
                steps.append(lg)
        return torch.cat(steps, dim=1)

    plain = run(cfg)
    ops.reset_launch_counts()
    kern = run(cfg.replace(use_pallas=True))
    torch.cuda.synchronize()
    counts = ops.launch_counts()
    assert counts == dict(dict.fromkeys(counts, 0), flash_attention=flash,
                          decode_attention=decode * 4)
    torch.testing.assert_close(kern, plain, **TOL_CPU)


def _batch(cfg, seed, device):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab, (4, 64)).astype(np.int32)
    labels = np.roll(toks, -1, axis=1)
    labels[:, -2:] = -1
    return {"tokens": torch.as_tensor(toks, device=device),
            "labels": torch.as_tensor(labels, device=device)}


def _run(cfg, state, device, steps):
    step_fn = make_train_step(cfg, build_optimizer(cfg,
                                                   total_steps=TOTAL_STEPS))
    state = _to(state, device)
    metrics = []
    for i in range(steps):
        state, m = step_fn(state, _batch(cfg, 50 + i, device))
        metrics.append(m)
    return state, metrics


@pytest.mark.parametrize("name", [PHI, ZAMBA])
def test_train_steps_card_against_cpu_and_bitwise(cuda, name):
    cfg = get_reduced(name)
    state = init_train_state(torch.Generator().manual_seed(0), cfg,
                             build_optimizer(cfg, total_steps=TOTAL_STEPS))
    ops.reset_launch_counts()
    got, gm = _run(cfg, state, cuda, 2)
    torch.cuda.synchronize()
    assert ops.launch_counts()["segment_sum"] == 2  # the embedding's grad
    again, am = _run(cfg, state, cuda, 2)
    want, wm = _run(cfg, state, "cpu", 2)
    for a, b, c in zip(gm, wm, am):
        for k in ("loss", "grad_norm"):
            torch.testing.assert_close(a[k].cpu(), b[k], **TOL_CPU)
            assert torch.equal(a[k], c[k])
    lr = float(lr_schedule(TOTAL_STEPS)(1))
    for a, b in zip(tree.leaves(got.params), tree.leaves(want.params)):
        torch.testing.assert_close(a.cpu(), b, atol=lr, rtol=0)
    assert all(torch.equal(a, b) for a, b in zip(tree.leaves(got),
                                                 tree.leaves(again)))
