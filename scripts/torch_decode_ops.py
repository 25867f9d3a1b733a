#!/usr/bin/env python3
"""How many top-level aten calls one LM decode step makes a layer, counted
on the CPU: the host work an eager decode step issues, whatever the width.

    python3 scripts/torch_decode_ops.py [--arch NAME ...]

For each arch (its reduced config: the op count of a layer does not depend
on the width), one decode step after a 4 x 16 prefill is profiled at 1 and
at 4 layers (decoder layers for an encoder-decoder arch, after a 16-token
prefix over 24 frames); the difference over 3 is the calls a layer.  Views and
reshapes count too (they cost host time but launch nothing), so the
figure bounds the layer's kernel launches from above.  Prints one line an
arch, then one JSON line.
"""
import argparse
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def decode_calls(tf, cfg, n_layers: int) -> int:
    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.nn import encdec as ed

    toks = torch.randint(0, cfg.vocab, (4, 16),
                         generator=torch.Generator().manual_seed(1))
    with torch.inference_mode():
        if cfg.family == "encdec":
            cfg = cfg.replace(dec_layers=n_layers)
            params = ed.init_encdec_params(torch.Generator().manual_seed(0),
                                           cfg)
            frames = torch.randn((4, 24, cfg.d_model),
                                 generator=torch.Generator().manual_seed(2))
            _, pf = ed.encdec_prefill(params, cfg, frames, toks)
            caches = ed.init_encdec_caches(cfg, 4, 20, 24, "cpu")
            for name, t in pf.items():
                caches[name][:, :, :t.shape[2]] = t
            with profile(activities=[ProfilerActivity.CPU]) as prof:
                ed.encdec_decode_step(params, cfg, toks[:, :1], caches, 16)
        else:
            cfg = cfg.replace(n_layers=n_layers)
            params = tf.init_lm_params(torch.Generator().manual_seed(0), cfg)
            lg, pf = tf.lm_prefill(params, cfg, toks)
            caches = tf.graft_prefill_caches(
                cfg, tf.init_kv_caches(cfg, 4, 20, "cpu"), pf, 16)
            with profile(activities=[ProfilerActivity.CPU]) as prof:
                tf.lm_decode_step(params, cfg, toks[:, :1], caches, 16)
    return sum(1 for e in prof.events()
               if e.name.startswith("aten::") and e.cpu_parent is None)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", nargs="+", default=[
        "granite-8b", "phi3.5-moe-42b-a6.6b", "mamba2-2.7b"])
    args = ap.parse_args()
    sys.path.insert(0, os.path.join(ROOT, "src"))
    from repro_torch.configs.registry import get_reduced
    from repro_torch.nn import transformer as tf

    out = {}
    for name in args.arch:
        cfg = get_reduced(name)
        one, four = decode_calls(tf, cfg, 1), decode_calls(tf, cfg, 4)
        out[name] = {"calls_1_layer": one, "calls_4_layers": four,
                     "calls_a_layer": (four - one) / 3}
        print(f"{name}: {(four - one) / 3:.1f} top-level aten calls a "
              f"decode layer ({one} at 1 layer, {four} at 4)")
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
