"""The port's LM serving (``serve/engine.py`` ``ServeEngine``, the LM
branch of ``launch/serve.py``) against the reference's engine on the same
parameters: greedy tokens must be equal, token for token, in the setups of
``tests/test_system.py`` and with prompts of several lengths (left-padded
with token 0, attended, as the reference does)."""
import argparse
import subprocess
import sys

import jax
import numpy as np
import pytest

from repro.configs.base import ModelConfig as JConfig
from repro.nn.transformer import init_lm_params as j_init
from repro.serve.engine import Request as JRequest
from repro.serve.engine import ServeEngine as JEngine
from repro_torch.configs.base import ModelConfig
from repro_torch.interop import params_from_numpy
from repro_torch.launch import serve as tserve
from repro_torch.serve.engine import Request, ServeEngine


def _models(tiny_cfg_base, **kw):
    jcfg = JConfig(name="d", family="dense", **tiny_cfg_base, **kw)
    jp = j_init(jax.random.key(0), jcfg)
    return jcfg, jp, params_from_numpy(jp, "cpu")


def _prompts(seed, lens, vocab):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab, n).astype(np.int32) for n in lens]


@pytest.mark.parametrize("slots,max_len,lens,max_tokens,kw", [
    (2, 48, [8, 8, 8], 6, {}),  # tests/test_system.py's engine test
    (1, 32, [8], 5, {}),  # ... and its determinism test
    (3, 40, [5, 8, 3, 7], 9, {}),  # ragged prompts: left-padding
    (2, 40, [20, 12], 12, {"sliding_window": 16}),  # the ring cache
])
@pytest.mark.parametrize("use_pallas", [False, True])
def test_greedy_tokens_equal_the_reference(tiny_cfg_base, slots, max_len,
                                           lens, max_tokens, kw, use_pallas):
    jcfg, jp, tp = _models(tiny_cfg_base, **kw)
    prompts = _prompts(len(lens), lens, jcfg.vocab)
    want = JEngine(jcfg, jp, batch_slots=slots, max_len=max_len).generate(
        [JRequest(prompt=p, max_tokens=max_tokens) for p in prompts])
    cfg = ModelConfig(name="d", family="dense", use_pallas=use_pallas,
                      **tiny_cfg_base, **kw)
    engine = ServeEngine(cfg, tp, batch_slots=slots, max_len=max_len)
    got = engine.generate([Request(prompt=p, max_tokens=max_tokens)
                           for p in prompts])
    assert [r.out_tokens for r in got] == [r.out_tokens for r in want]
    assert all(len(r.out_tokens) == max_tokens for r in got)
    waves = -(-len(lens) // slots)
    assert len(engine.timings) == waves
    assert engine.timings[0]["decode_steps"] == max_tokens - 1


def test_sampling_is_reproducible_from_the_engine_seed(tiny_cfg_base):
    _, _, tp = _models(tiny_cfg_base)
    cfg = ModelConfig(name="d", family="dense", **tiny_cfg_base)
    prompts = _prompts(5, [8, 8], cfg.vocab)

    def run(seed, temps=(0.9, 0.0)):
        eng = ServeEngine(cfg, tp, batch_slots=2, max_len=32, rng_seed=seed)
        return [r.out_tokens for r in eng.generate(
            [Request(prompt=p, max_tokens=10, temperature=t)
             for p, t in zip(prompts, temps)])]

    first = run(0)
    assert run(0) == first
    assert run(1)[0] != first[0]  # another seed, another sample
    greedy = run(0, temps=(0.0, 0.0))
    assert first[1] == greedy[1]  # a greedy slot in a sampled wave
    assert all(0 <= t < cfg.vocab for r in first for t in r)


def test_eos_ends_a_request(tiny_cfg_base):
    _, _, tp = _models(tiny_cfg_base)
    cfg = ModelConfig(name="d", family="dense", **tiny_cfg_base)
    prompt = _prompts(1, [8], cfg.vocab)[0]
    free = ServeEngine(cfg, tp, batch_slots=1, max_len=32).generate(
        [Request(prompt=prompt, max_tokens=6)])[0].out_tokens
    eos = free[2]
    cut = ServeEngine(cfg, tp, batch_slots=1, max_len=32,
                      eos_id=eos).generate(
        [Request(prompt=prompt, max_tokens=6)])[0].out_tokens
    assert cut == free[:free.index(eos) + 1]


def _args(**kw):
    base = dict(arch="smollm-360m", reduced=True, requests=2, prompt_len=6,
                max_tokens=3, temperature=0.0, slots=2, use_pallas=False,
                device="cpu")
    return argparse.Namespace(**{**base, **kw})


def test_cli_families_outside_the_slice(capsys):
    """The encdec family exits as the reference's CLI does; a vlm serves
    (its dense stack, no frontend embeddings), as granite does."""
    with pytest.raises(SystemExit, match="decoder-only"):
        tserve.run_lm(_args(arch="seamless-m4t-medium"))
    for arch in ("internvl2-76b", "granite-8b"):
        tserve.run_lm(_args(arch=arch, use_pallas=True))
        out = capsys.readouterr().out.splitlines()
        assert out[0].startswith("req0: [") and out[1].startswith("req1: [")
        assert out[2].startswith("6 tokens in ")


def test_cli_serves_reduced_smollm_on_cpu():
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--arch",
         "smollm-360m", "--reduced", "--device", "cpu"],
        capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    lines = out.stdout.strip().splitlines()
    assert [ln.split(":")[0] for ln in lines[:8]] == [
        f"req{i}" for i in range(8)]
    assert all(len(eval(ln.split(": ", 1)[1])) == 16 for ln in lines[:8])
    assert lines[8].startswith("128 tokens in ") and "tok/s" in lines[8]
