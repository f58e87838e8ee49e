"""Batched LM serving demo on the PyTorch port: the decode engine over the
ported archs.

The twin of ``examples/serve_lm.py`` over ``repro_torch``: exact-length
request batching, prefill + token-by-token decode with per-slot EOS, and
the per-family decode state (KV cache, SSM state and conv buffer, mLSTM
matrix memory, sLSTM cells, MLA's compressed cache).  Enc-dec archs get
stub audio frames.  It runs on the GPU unless ``--device cpu`` is given;
``--reduced`` takes the same family at smoke scale (random weights either
way).  The MoE archs (deepseek-v2-236b, arctic-480b) exceed one card at
their published depth: serve them ``--reduced``.

Run:  PYTHONPATH=src python examples/serve_lm_torch.py --arch zamba2-2.7b \
          --reduced --device cpu [--requests 6] [--temperature 0.8]
"""
from __future__ import annotations

import argparse

import numpy as np

from repro_torch.configs import get_config, list_archs
from repro_torch.launch.serve import Request, ServeEngine
from repro_torch.models.lm import get_model


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="zamba2-2.7b", choices=list_archs())
    ap.add_argument("--requests", type=int, default=6)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--reduced", action="store_true",
                    help="smoke-scale config (small widths, f32)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the GPU)")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    params = get_model(cfg).init(0, device=args.device)
    eng = ServeEngine(cfg, params, max_batch=4, temperature=args.temperature,
                      device=args.device)

    rng = np.random.default_rng(0)
    lens = rng.choice([8, 8, 12], size=args.requests)   # mixed-length queue
    reqs = [Request(prompt=rng.integers(0, cfg.vocab_size, n).astype(np.int32),
                    max_new_tokens=args.max_new) for n in lens]

    if cfg.encoder_layers > 0:
        frames = rng.standard_normal(
            (len(reqs), 8, cfg.d_model)).astype(np.float32)
        same = [r for r in reqs if len(r.prompt) == len(reqs[0].prompt)]
        comps = eng.generate_batch(same[:eng.max_batch],
                                   frame_embeds=frames[:min(len(same),
                                                            eng.max_batch)])
    else:
        comps = eng.serve(reqs)

    print(f"arch={cfg.name} family={cfg.family} layers={cfg.num_layers} "
          f"d_model={cfg.d_model} (reduced={args.reduced}) "
          f"device={eng.device}")
    for i, c in enumerate(comps):
        tps = c.steps / max(c.decode_s, 1e-9)
        more = "..." if len(c.tokens) > 8 else ""
        print(f"req{i} (len {len(reqs[i].prompt)}): "
              f"tokens={c.tokens[:8].tolist()}{more} "
              f"prefill={c.prefill_s * 1e3:.0f}ms decode={tps:,.0f} tok/s")


if __name__ == "__main__":
    main()
