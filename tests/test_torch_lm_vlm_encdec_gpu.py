"""The VLM and encoder-decoder families on the card: the ``flash_attention``
kernel's non-causal and cross forms (``Sk != Sq``) against their plain
version and the CPU emulation, and the reduced internvl2 and seamless
models, kernel arm against plain arm.  Every test needs a CUDA device and
skips without one.  The file imports no jax:

    PYTHONPATH=src python -m pytest --noconftest -p no:cacheprovider \\
        -m gpu tests/test_torch_lm_vlm_encdec_gpu.py

Tolerances: TF32 off; the kernel against the plain version at 2e-4 in fp32
and 2e-2 in bf16 (``tests/test_torch_kernels_gpu.py``'s: online softmax
over tiles against one softmax; the bf16 plain version rounds the scores
and P to bf16), against its emulation at 1e-5 in fp32 (the same tile
order) and 2e-2 in bf16; two launches bitwise (no atomics); the kernel
arm against the plain arm at 1e-4 with exact launches.
"""
import numpy as np
import pytest
import torch

from repro_torch.configs.registry import get_reduced
from repro_torch.kernels import flash_attention as tflash
from repro_torch.kernels import ops
from repro_torch.nn import encdec as ted
from repro_torch.nn import transformer as ttf

pytestmark = pytest.mark.gpu
TOL_ARM = dict(atol=1e-4, rtol=1e-4)
ATTN_TOL = {torch.float32: dict(atol=2e-4, rtol=2e-4),
            torch.bfloat16: dict(atol=2e-2, rtol=2e-2)}
EMU_TOL = {torch.float32: dict(atol=1e-5, rtol=1e-5),
           torch.bfloat16: dict(atol=2e-2, rtol=2e-2)}
VLM, ENCDEC = "internvl2-76b", "seamless-m4t-medium"


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


CROSS_SHAPES = [  # (B, Sq, Sk, H, KVH, Dh)
    (1, 70, 1, 4, 2, 16),  # one key
    (2, 130, 1000, 4, 4, 64),  # a ragged seamless-like cross
    (1, 1024, 200, 16, 16, 64),  # Sk < Sq
    (2, 65, 63, 6, 2, 128),  # one tile each side, ragged
    (1, 100, 321, 8, 2, 120),  # the K ring round twice, Dh 120
    (2, 257, 300, 2, 1, 7),  # odd Dh: 2-byte copies
    (1, 200, 200, 16, 16, 64),  # the encoder's non-causal self form
]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", CROSS_SHAPES)
def test_cross_form_matches_plain_and_emulation(cuda, shape, dtype):
    b, sq, sk, h, kvh, dh = shape
    rng = np.random.default_rng(sq * sk + dh)

    def draw(*s):
        return torch.as_tensor(rng.standard_normal(s) * 0.5,
                               dtype=torch.float32, device=cuda).to(dtype)

    q, k, v = draw(b, sq, h, dh), draw(b, sk, kvh, dh), draw(b, sk, kvh, dh)
    before = tflash.flash_attention.launches
    got = tflash.flash_attention(q, k, v, causal=False)
    torch.cuda.synchronize()
    assert tflash.flash_attention.launches == before + 1
    assert got.dtype == dtype and got.shape == q.shape
    assert torch.isfinite(got).all()
    want = tflash.flash_attention_plain(q, k, v, causal=False)
    torch.testing.assert_close(got.float(), want.float(), **ATTN_TOL[dtype])
    emu = tflash.flash_attention_emulate(q, k, v, causal=False)
    torch.testing.assert_close(got.float(), emu.float(), **EMU_TOL[dtype])
    assert torch.equal(got, tflash.flash_attention(q, k, v, causal=False))


def test_cross_form_refuses_a_causal_or_windowed_call(cuda):
    q = torch.zeros((1, 64, 2, 16), device=cuda)
    k = torch.zeros((1, 80, 2, 16), device=cuda)
    before = tflash.flash_attention.launches
    with pytest.raises(ValueError, match="cross form"):
        tflash.flash_attention(q, k, k)
    with pytest.raises(ValueError, match="cross form"):
        tflash.flash_attention(q, k, k, causal=False, window=8)
    assert tflash.flash_attention.launches == before


def test_vlm_kernel_arm_against_plain_arm(cuda):
    """Reduced internvl2: prefill of 8 embeddings + 32 tokens, then 4
    teacher-forced decode steps at positions ``E + t``, and the full
    forward; launches exact (2 a prefill or forward, 2 a step)."""
    cfg = get_reduced(VLM)
    e = cfg.n_frontend_embeds
    params = ttf.init_lm_params(torch.Generator(device=cuda).manual_seed(0),
                                cfg)
    rng = np.random.default_rng(5)
    toks = torch.as_tensor(rng.integers(0, cfg.vocab, (2, 36)), device=cuda)
    extra = torch.as_tensor(rng.standard_normal((2, e, cfg.d_model)) * 0.1,
                            dtype=torch.float32, device=cuda)

    def run(c):
        with torch.inference_mode():
            full, _ = ttf.lm_forward(params, c, toks, extra_embeds=extra)
            lg, pf = ttf.lm_prefill(params, c, toks[:, :32],
                                    extra_embeds=extra)
            caches = ttf.graft_prefill_caches(
                c, ttf.init_kv_caches(c, 2, e + 36, cuda), pf, e + 32)
            steps = [lg]
            for t in range(32, 36):
                lg, caches = ttf.lm_decode_step(params, c, toks[:, t:t + 1],
                                                caches, e + t)
                steps.append(lg)
        return full, torch.cat(steps, dim=1)

    plain = run(cfg)
    ops.reset_launch_counts()
    kern = run(cfg.replace(use_pallas=True))
    torch.cuda.synchronize()
    counts = ops.launch_counts()
    assert counts == dict(dict.fromkeys(counts, 0), flash_attention=4,
                          decode_attention=8)
    for a, b in zip(kern, plain):
        torch.testing.assert_close(a, b, **TOL_ARM)
    torch.testing.assert_close(kern[1][:, :-1], kern[0][:, 31:35], **TOL_ARM)


def test_encdec_kernel_arm_against_plain_arm(cuda):
    """Reduced seamless: ``encdec_forward`` (2 encoder, 2 x 2 decoder
    launches) and ``encdec_prefill`` + 4 decode steps (2 decode_attention
    launches a step; the cross step is the plain function on both arms),
    kernel arm against plain arm, and two kernel runs bitwise."""
    cfg = get_reduced(ENCDEC)
    params = ted.init_encdec_params(
        torch.Generator(device=cuda).manual_seed(0), cfg)
    rng = np.random.default_rng(6)
    frames = torch.as_tensor(rng.standard_normal((2, 90, cfg.d_model)) * 0.3,
                             dtype=torch.float32, device=cuda)
    toks = torch.as_tensor(rng.integers(0, cfg.vocab, (2, 20)), device=cuda)

    def run(c):
        with torch.inference_mode():
            full = ted.encdec_forward(params, c, frames, toks)
            lg, pf = ted.encdec_prefill(params, c, frames, toks[:, :16])
            caches = ted.graft_encdec_caches(c, pf, 20)
            steps = [lg]
            for t in range(16, 20):
                lg, caches = ted.encdec_decode_step(params, c,
                                                    toks[:, t:t + 1], caches,
                                                    t)
                steps.append(lg)
        return full, torch.cat(steps, dim=1)

    plain = run(cfg)
    ops.reset_launch_counts()
    kern = run(cfg.replace(use_pallas=True))
    torch.cuda.synchronize()
    counts = ops.launch_counts()
    assert counts == dict(dict.fromkeys(counts, 0), flash_attention=12,
                          decode_attention=8)
    for a, b in zip(kern, plain):
        torch.testing.assert_close(a, b, **TOL_ARM)
    torch.testing.assert_close(kern[1][:, :-1], kern[0][:, 15:19], **TOL_ARM)
    again = run(cfg.replace(use_pallas=True))
    assert all(torch.equal(a, b) for a, b in zip(kern, again))
